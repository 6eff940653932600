"""One train step of the mixture-of-experts models (deepseek-v3-671b
with MLA and MTP, kimi-k2-1t-a32b) in the port against the JAX package's
at each config's ``SMOKE`` shape, on the CPU, from JAX's train state
carried across by ``convert.train_state_from_flat``: the loss (cross
entropy + 0.01 aux + 0.3 MTP), the gradient norm, and every packed word
after Madam's update, the 4-D expert stacks' included.

Tolerances (``test_torch_recurrent.py``'s rule): full precision at f32,
loss and grad norm within 1e-5 relative, a word apart from JAX's only by
one code (a rounding tie, H6) or 32 (at step 1 Madam moves a word by
sign(g)·lr·γ = 16 codes, so a gradient whose sign the frameworks'
rounding decides), at most 1e-4 of them; ``lns_madam`` at f32, loss
within 1e-3, grad norm 10%, at most 5% of the words apart (a Q_A code
may flip where an ulp of log2 sits on a rounding tie, H1, and every
gradient near zero downstream may change sign).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.optim.madam import MadamConfig as JMadamConfig  # noqa: E402
from repro.training import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.checkpoint.manager import flatten_state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.optim.madam import MadamConfig  # noqa: E402

from test_torch_model import flat_params  # noqa: E402

MOE = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_smoke_config(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


@pytest.mark.parametrize("qname", ["fp32", "lns8"])
@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_jax(arch, qname):
    """One step from JAX's train state at f32: loss (aux and MTP in it),
    grad norm and the new packed words, the expert stacks' included."""
    from repro.training import build_train_step as j_build
    from repro.training.data import SyntheticLM as JSyntheticLM
    from repro_torch.convert import train_state_from_flat
    from repro_torch.training.steps import build_train_step
    jq, tq = {"fp32": (JQuantConfig.full_precision(),
                       QuantConfig.full_precision()),
              "lns8": (JQuantConfig.lns_madam(),
                       QuantConfig.lns_madam())}[qname]
    jcfg, tcfg = _cfgs(arch)
    jmcfg = JMadamConfig()
    js = jax.jit(lambda k: j_init_train_state(k, jcfg, jmcfg))(
        jax.random.PRNGKey(0))
    ts = train_state_from_flat(flat_params(js), MadamConfig(), device="cpu")
    b = JSyntheticLM(jcfg, batch=2, seq=16).batch_at(0)
    with jd.configured(backend="reference"):
        jstep = jax.jit(j_build(jcfg, jq, jmcfg))
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tmet = build_train_step(tcfg, tq, MadamConfig())(ts, b)
    exact = qname == "fp32"
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5 if exact else 1e-3)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=1e-5 if exact else 0.1)
    jf, tf = flat_params(js.params), flatten_state(ts.params)
    assert set(jf) == set(tf)
    assert any("w_down::packed" in k for k in jf)
    n = tot = 0
    for k in jf:
        if k.endswith("packed"):
            jw, tw = jf[k].astype(np.int64), tf[k].astype(np.int64)
            diff = jw != tw
            n += int(diff.sum())
            tot += jw.size
            if exact:
                assert set(np.abs(jw - tw)[diff].tolist()) <= {1, 32}, k
    assert n <= (1e-4 if exact else 0.05) * tot, (n, tot)
