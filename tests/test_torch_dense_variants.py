"""The dense variants of the port (granite-8b, qwen2.5-32b, gemma3-12b)
against the JAX package at each config's ``SMOKE`` shape, on the CPU,
with JAX parameters carried across by ``convert.params_from_flat`` and
inputs drawn from numpy seeds; and the repairs the variants needed
(lists in the parameter trees, layer-sliced encoding, remat, K5's
head_dim guard).

Tolerances:
* Configs and ``params_count()``: equal.
* Forward logits with no quantizer (``qcfg=None``, f32 dense weights,
  every zero-initialized gain and bias replaced by random values so the
  norms, qk-norm and QKV bias are exercised): 2e-5 absolute, as the
  frameworks' f32 rsqrt, exp and sum orders differ by ULPs (logits O(1)).
* ``decode_step`` against ``forward`` of the port across a ring wrap:
  2e-5 absolute (measured ~1e-6: only the summation order of a shorter
  key set differs).
* One lns8 train step: the rule of ``test_torch_model.py``
  (loss within 5e-5 relative, grad norm within 10%, at most 2% of the
  packed words differing).
* Engine streams (f32 smoke config): equal. Greedy rows against JAX's
  engine on JAX's draw and on the port's seed-0 draw carried into JAX
  (with the spec and paging counters); phase 21c's mixed rows, k=3
  against the baseline, on JAX's draw.
* K5's plain version at head_dim 256 against JAX's reference: rtol and
  atol 2e-5, as ``test_torch_kernels_ref.py`` holds head_dim 32.
* Encodes and remat: bit-equal.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.common import ArchConfig as JArchConfig  # noqa: E402
from repro.optim.madam import MadamConfig as JMadamConfig  # noqa: E402
from repro.training import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat, is_lns_weight, lns_weight_encode  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim.madam import (MadamConfig, init_lns_params,  # noqa: E402
                                     lns_leaf_encoder)
from repro_torch.tree import leaves, tree_map, tree_set  # noqa: E402

from test_torch_kernels_ref import _paged_inputs  # noqa: E402
from test_torch_model import flat_params  # noqa: E402

VARIANTS = ["granite-8b", "qwen2.5-32b", "gemma3-12b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gemma8(base):
    """gemma3's smoke config at 8 layers: a 2-layer local prefix, then one
    5:1 period."""
    return dataclasses.replace(base, num_layers=8)


def _cfgs(name):
    """(JAX config, port config) of a test case name."""
    if name == "gemma3-8":
        return (_gemma8(j_smoke_config("gemma3-12b")),
                _gemma8(get_smoke_config("gemma3-12b")))
    return j_smoke_config(name), get_smoke_config(name)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", VARIANTS + ["smollm-135m"])
def test_configs_and_params_count_match_jax(arch):
    """Field for field as JAX's (every JAX field the port does not carry
    sits at JAX's default), the same layer pattern and the same
    parameter count, at full width and at the smoke shape."""
    assert arch in ARCHS
    tf = {f.name for f in dataclasses.fields(get_config(arch))}
    for t, j in ((get_config(arch), j_config(arch)),
                 (get_smoke_config(arch), j_smoke_config(arch)),
                 (_gemma8(get_smoke_config(arch)),
                  _gemma8(j_smoke_config(arch)))):
        for f in dataclasses.fields(JArchConfig):
            if f.name in tf:
                assert getattr(t, f.name) == getattr(j, f.name), f.name
            else:
                assert getattr(j, f.name) == f.default, f.name
        assert t.layer_pattern() == j.layer_pattern()
        assert t.params_count() == j.params_count()


# ---------------------------------------------------------------------------
# forward and decode


def _perturbed_dense(jcfg, seed):
    """JAX's dense f32 parameters of ``jcfg``, every zero leaf (gains,
    biases) replaced by small random values."""
    params = jax.jit(lambda k: jm.init_params(k, jcfg))(jax.random.PRNGKey(0))
    flat = flat_params(params)
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if not np.any(v):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    return flat


def _unflat(flat, like):
    """The JAX pytree ``like`` with its leaves taken from ``flat``."""
    paths, tdef = jax.tree_util.tree_flatten_with_path(like)
    keys = ["::".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in p) for p, _ in paths]
    return jax.tree_util.tree_unflatten(tdef,
                                        [jnp.asarray(flat[k]) for k in keys])


@pytest.mark.parametrize("name", VARIANTS + ["gemma3-8"])
def test_forward_logits_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    flat = _perturbed_dense(jcfg, seed=11)
    jparams = _unflat(flat, jax.eval_shape(
        lambda: jm.init_params(jax.random.PRNGKey(0), jcfg)))
    tp = params_from_flat(flat, LNSFormat(8, 8), device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl = np.asarray(jax.jit(lambda p, t: jm.forward(p, t, jcfg, None).logits)(
        jparams, jnp.asarray(tokens)))
    tl = tm.forward(tp, torch.from_numpy(tokens), tcfg, None).numpy()
    assert isinstance(tp.get("prefix", []), list)
    assert ("prefix" in tp) == bool(tcfg.layer_pattern()[0])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)


@pytest.mark.parametrize("chunk", [1, 3, 20])
@pytest.mark.parametrize("slack", [0, 3])
def test_decode_equals_forward_across_ring_wrap(chunk, slack):
    """20 tokens through rings of 8 (+ slack) positions, appended
    ``chunk`` at a time (20: one call longer than the ring, the roll
    path), against the training forward."""
    cfg = _gemma8(get_smoke_config("gemma3-12b"))
    p = tm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20)))
    want = tm.forward(p, tokens, cfg, None)
    caches = tm.init_caches(2, 32, cfg, window_slack=slack, device="cpu")
    assert caches["prefix"][0]["k"].shape[1] == 8 + slack
    got, t = [], 0
    while t < 20:
        n = min(chunk, 20 - t)
        got.append(tm.forward(p, tokens[:, t:t + n], cfg, None, caches=caches,
                              pos_offset=t))
        t += n
    assert int(caches["prefix"][0]["idx"][0]) == 20
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# one lns8 train step


@pytest.mark.parametrize("arch", VARIANTS)
def test_lns8_train_step_matches_jax(arch):
    from repro.training import build_train_step as j_build
    from repro.training.data import SyntheticLM as JSyntheticLM
    from repro_torch.checkpoint.manager import flatten_state
    from repro_torch.convert import train_state_from_flat
    from repro_torch.training.steps import build_train_step
    jcfg, tcfg = _cfgs(arch)
    jmcfg = JMadamConfig()
    js = jax.jit(lambda k: j_init_train_state(k, jcfg, jmcfg))(
        jax.random.PRNGKey(0))
    ts = train_state_from_flat(flat_params(js), MadamConfig(), device="cpu")
    b = JSyntheticLM(jcfg, batch=2, seq=16).batch_at(0)
    with jd.configured(backend="reference"):
        jstep = jax.jit(j_build(jcfg, JQuantConfig.lns_madam(), jmcfg))
    js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tmet = build_train_step(tcfg, QuantConfig.lns_madam(),
                                MadamConfig())(ts, b)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=5e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=0.1)
    jf, tf = flat_params(js.params), flatten_state(ts.params)
    assert set(jf) == set(tf)
    n = tot = 0
    for k in jf:
        if k.endswith("packed"):
            n += int(np.sum(jf[k].astype(np.int64) != tf[k].astype(np.int64)))
            tot += jf[k].size
    assert n <= 0.02 * tot, (n, tot)


# ---------------------------------------------------------------------------
# serving: gemma3-smoke's rings and global pools against JAX's engine


def _greedy(vocab, n=4, gen=10, seed=3):
    """``tests/test_spec.py``'s mixed lengths, every row greedy."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, (4 + (i % 3) * 3,)).tolist(), max_new_tokens=gen - (i % 4))
        for i in range(n)]


_SPEC_KW = dict(num_slots=2, max_len=32, page_size=8, num_pages=8,
                prefix_cache=False, alloc_policy="ondemand")


def _mixed(vocab, n=4, gen=10, seed=3):
    """``tests/test_spec.py``'s ``_mixed_requests``: greedy and seeded
    sampled rows interleaved (phase 21c's requests on the card)."""
    from repro_torch.server.sampling import SamplingParams
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = None if i % 2 == 0 else SamplingParams(
            temperature=0.9, top_k=0 if i % 4 == 1 else 8, seed=100 + i)
        prompt = rng.integers(0, vocab, (4 + (i % 3) * 3,)).tolist()
        out.append(Request(rid=i, prompt=prompt,
                           max_new_tokens=gen - (i % 4), sampling=sp))
    return out


def _streams(e):
    return {rs.request.rid: [int(t) for t in rs.generated]
            for rs in e.finished}


@pytest.fixture(scope="module")
def gemma3_smoke_draws():
    """gemma3-smoke's JAX draw (``PRNGKey(0)``) and the port's seed-0
    draw, each as both frameworks' trees: ``{"jax": (jax tree, port
    tree), "port": (jax tree, port tree)}``."""
    from repro_torch.checkpoint.manager import flatten_state
    jcfg = j_smoke_config("gemma3-12b")
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    jparams = jax.jit(lambda k: j_init_train_state(k, jcfg, jmcfg).params)(
        jax.random.PRNGKey(0))
    fmt = LNSFormat(8, 8)
    tp = params_from_flat(flat_params(jparams), fmt, device="cpu")
    own = tm.init_params(get_smoke_config("gemma3-12b"), seed=0,
                         device="cpu", leaf_fn=lns_leaf_encoder(
                             MadamConfig(update_format=fmt)))
    flat = flatten_state(own)
    paths, treedef = jax.tree_util.tree_flatten_with_path(jparams)

    def key(path):
        return "::".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)

    assert sorted(flat) == sorted(key(p) for p, _ in paths)
    j_own = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat[key(p)].astype(np.asarray(x).dtype)).reshape(
            x.shape) for p, x in paths])
    return {"jax": (jparams, tp), "port": (j_own, own)}


def test_gemma3_engine_streams_match_jax(gemma3_smoke_draws):
    """JAX's ``test_spec_equals_baseline_sliding_window`` setup (2 slots,
    max_len 32, page 8, 8 pages, ondemand, spec k=3 at 7 bits) with
    greedy rows: the port's speculating engine equals JAX's (one JAX
    engine), and the port's non-speculating engine equals both."""
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro_torch.serving import Engine
    jcfg = j_smoke_config("gemma3-12b")
    tcfg = get_smoke_config("gemma3-12b")
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    jparams, tp = gemma3_smoke_draws["jax"]
    spec = dict(speculate_k=3, draft_bitwidth=7)
    reqs = _greedy(tcfg.vocab_size)
    with jd.configured(backend="reference"):
        jeng = JEngine(jcfg, JQuantConfig.lns_madam(), jmcfg, jparams,
                       **_SPEC_KW, **spec)
        jeng.run([JRequest(rid=r.rid, prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens) for r in reqs])
    eng = Engine(tcfg, QuantConfig.lns_madam(), tp, device="cpu", **_SPEC_KW,
                 **spec)
    eng.run(reqs)
    base = Engine(tcfg, QuantConfig.lns_madam(), tp, device="cpu", **_SPEC_KW)
    base.run(_greedy(tcfg.vocab_size))

    assert len(_streams(jeng)) == 4
    assert _streams(eng) == _streams(jeng) == _streams(base)
    for c in ("spec_cycles", "spec_drafted", "spec_accepted",
              "spec_fallbacks", "decode_steps", "preemptions"):
        assert getattr(eng, c) == getattr(jeng, c), c
    assert eng.spec_cycles > 0
    # the rings carry the spec slack; the global layer is a pool
    assert eng.caches["period"]["pos0"]["k"].shape[2] == 8 + 3
    assert "kp" in eng.caches["period"]["pos5"]
    assert eng.allocator.in_use == base.allocator.in_use == 0
    assert not eng._prefix_ok


def test_gemma3_mixed_spec_equals_baseline_on_jax_draw(gemma3_smoke_draws):
    """Phase 21c's mixed requests under the paper's Q_A on JAX's draw,
    where JAX's ``test_spec_equals_baseline_sliding_window`` holds: the
    port's k=3 streams at 7 bits equal its baseline's, and no page stays
    in use."""
    from repro_torch.serving import Engine
    tcfg = get_smoke_config("gemma3-12b")
    _, tp = gemma3_smoke_draws["jax"]
    got = []
    for spec in ({}, dict(speculate_k=3, draft_bitwidth=7)):
        eng = Engine(tcfg, QuantConfig.lns_madam(), tp, device="cpu",
                     **_SPEC_KW, **spec)
        eng.run(_mixed(tcfg.vocab_size))
        assert len(eng.finished) == 4 and eng.allocator.in_use == 0
        got.append(_streams(eng))
    assert got[0] == got[1]


def test_gemma3_spec_streams_match_jax_on_port_draw(gemma3_smoke_draws):
    """The port's seed-0 draw carried into JAX: JAX's engine and the
    port's give the same greedy streams, baseline and k=3 at 7 bits, in
    the setup above. Where k=3 parts from the baseline on this draw
    (per-tensor Q_A over the verify's rows, H7) the reference parts the
    same way."""
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro_torch.serving import Engine
    jcfg = j_smoke_config("gemma3-12b")
    tcfg = get_smoke_config("gemma3-12b")
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    jparams, tp = gemma3_smoke_draws["port"]
    for spec in ({}, dict(speculate_k=3, draft_bitwidth=7)):
        reqs = _greedy(tcfg.vocab_size)
        with jd.configured(backend="reference"):
            jeng = JEngine(jcfg, JQuantConfig.lns_madam(), jmcfg, jparams,
                           **_SPEC_KW, **spec)
            jeng.run([JRequest(rid=r.rid, prompt=list(r.prompt),
                               max_new_tokens=r.max_new_tokens)
                      for r in reqs])
        eng = Engine(tcfg, QuantConfig.lns_madam(), tp, device="cpu",
                     **_SPEC_KW, **spec)
        eng.run(reqs)
        assert len(jeng.finished) == 4
        assert _streams(eng) == _streams(jeng), spec
        assert eng.spec_cycles == jeng.spec_cycles


def test_bucket_never_exceeds_the_window():
    from repro_torch.serving import Engine
    cfg = get_smoke_config("gemma3-12b")
    p = init_lns_params(tm.init_params(cfg, seed=0, device="cpu"),
                        MadamConfig(update_format=LNSFormat(8, 8)))
    eng = Engine(cfg, QuantConfig.lns_madam(), p, num_slots=2, max_len=64,
                 buckets=(4, 8, 16), device="cpu")
    assert [eng._bucket(n) for n in (3, 5, 8, 9, 20)] == [4, 8, 8, 9, 20]


def test_gemma3_draft_view_is_three_k7_calls(monkeypatch):
    """gemma3's view re-grids 6 x 7 stacked leaves, the embedding and the
    untied head (43 leaves when tied): more than ``K7_MAX_LEAVES`` = 16,
    so 3 grouped calls. The qk-norm gains and the scales stay shared by
    reference."""
    from repro_torch.serving import spec
    cfg = get_smoke_config("gemma3-12b")
    p = init_lns_params(tm.init_params(cfg, seed=0, device="cpu"),
                        MadamConfig(update_format=LNSFormat(8, 8)))
    calls = []
    real = dispatch.requant_pack_many
    monkeypatch.setattr(dispatch, "requant_pack_many", lambda w, s, d: (
        calls.append(len(w)), real(w, s, d))[1])
    view = spec.build_draft_params(p, 7)
    assert calls == [16, 16, 12]
    for j in range(6):
        a, b = p["period"][f"pos{j}"]["attn"], view["period"][f"pos{j}"]["attn"]
        assert b["q_norm"] is a["q_norm"] and b["k_norm"] is a["k_norm"]
        assert b["wq"].scale is a["wq"].scale
    assert view["embed"]["head"].scale is p["embed"]["head"].scale
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    q = init_lns_params(tm.init_params(tied, seed=0, device="cpu"),
                        MadamConfig(update_format=LNSFormat(8, 8)))
    calls.clear()
    spec.build_draft_params(q, 7)
    assert calls == [16, 16, 11]


def test_qwen_bias_is_shared_by_the_draft_view():
    from repro_torch.serving import spec
    cfg = get_smoke_config("qwen2.5-32b")
    p = init_lns_params(tm.init_params(cfg, seed=0, device="cpu"),
                        MadamConfig(update_format=LNSFormat(8, 8)))
    a = p["period"]["pos0"]["attn"]
    assert not any(is_lns_weight(a[k]) for k in ("bq", "bk", "bv"))
    view = spec.build_draft_params(p, 6)
    for k in ("bq", "bk", "bv"):
        assert view["period"]["pos0"]["attn"][k] is a[k]


# ---------------------------------------------------------------------------
# K5 at head_dim 256


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("S", [1, 4])
def test_k5_plain_head_dim_256_matches_jax(packed, S):
    """gemma3's global layers: 16 heads over 8 KV heads at head_dim 256,
    decode (S=1) and the verify's S=4."""
    jargs, targs = _paged_inputs(4, S, 16, 8, 256, 8, 4, packed, "bf16",
                                 seed=S)
    kw = dict(softcap=None, sm_scale=1 / math.sqrt(256))
    jf, tf = JFormat(8, 8), LNSFormat(8, 8)
    with jd.configured(backend="reference"):
        want = np.asarray(jd.paged_attend(*jargs, fmt=jf if packed else None,
                                          **kw))
    got = dispatch.paged_attend(*targs, fmt=tf if packed else None,
                                **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [96, 112, 80])
def test_k5_kernel_refuses_unbuilt_head_dims(hd):
    """80 is not instantiated: the wrapper names the supported head_dims
    before it looks at the device. 96 (phi-3-vision, since the modality
    slice), 112 (zamba2's shared attention, since the recurrent slice)
    and 256 pass that guard (and then need a CUDA tensor)."""
    q = torch.zeros((1, 1, 2, hd))
    pool = torch.zeros((3, 4, 1, hd), dtype=torch.bfloat16)
    bt, ln = torch.zeros((1, 1), dtype=torch.int32), torch.ones(
        (1,), dtype=torch.int32)
    built = {96: True, 112: True, 80: False}[hd]
    assert (hd in ops.PAGED_ATTEND_HEAD_DIMS) == built
    match = ("CUDA tensor" if built else
             r"head_dim .*\(16, 32, 64, 96, 112, 128, 256\)")
    with pytest.raises(ValueError, match=match):
        ops.paged_attend(q, pool, pool, None, None, bt, ln, sm_scale=1.0)
    q256 = torch.zeros((1, 1, 2, 256))
    p256 = torch.zeros((3, 4, 1, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.paged_attend(q256, p256, p256, None, None, bt, ln, sm_scale=1.0)
    assert 256 in ops.PAGED_ATTEND_HEAD_DIMS


# ---------------------------------------------------------------------------
# repairs: trees with lists, sliced encodes, init draws, remat


def test_trees_take_lists():
    tree = {"a": [torch.ones(2), {"b": torch.zeros(3)}], "c": torch.ones(1)}
    assert [p for p, _ in leaves(tree)] == [("a", 0), ("a", 1, "b"), ("c",)]
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert isinstance(doubled["a"], list)
    assert torch.equal(doubled["a"][0], 2 * torch.ones(2))
    out = {}
    for p, x in leaves(tree):
        tree_set(out, p, x)
    assert isinstance(out["a"], list) and out["a"][1]["b"] is tree["a"][1]["b"]
    enc = init_lns_params({"prefix": [{"w": torch.randn(8, 4),
                                       "g": torch.randn(4)}]},
                          MadamConfig(update_format=LNSFormat(8, 8)))
    assert is_lns_weight(enc["prefix"][0]["w"])
    assert enc["prefix"][0]["g"].dtype == torch.float32


def test_prefix_round_trips_through_the_checkpoint_layout():
    """JAX's ``prefix::0::...`` keys read back into a list, and the port's
    checkpoint layout writes the same keys."""
    from repro_torch.checkpoint.manager import flatten_state
    jcfg, tcfg = _cfgs("gemma3-8")
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    jparams = jax.jit(lambda k: j_init_train_state(k, jcfg, jmcfg).params)(
        jax.random.PRNGKey(0))
    flat = flat_params(jparams)
    tp = params_from_flat(flat, LNSFormat(8, 8), device="cpu")
    assert isinstance(tp["prefix"], list) and len(tp["prefix"]) == 2
    # JAX's rank rule: prefix weights are packed, prefix gains are not
    assert is_lns_weight(tp["prefix"][0]["attn"]["wq"])
    assert not is_lns_weight(tp["prefix"][0]["ln1"])
    back = flatten_state(tp)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].astype(np.int64)
                                      if back[k].dtype.kind in "iu"
                                      else back[k], flat[k].astype(np.int64)
                                      if flat[k].dtype.kind in "iu"
                                      else flat[k])
    # the port's own encode of the same layout follows the same rank rule
    dense = tm.init_params(tcfg, seed=0, device="cpu")
    enc = init_lns_params(dense, MadamConfig(update_format=LNSFormat(8, 8)))
    assert sorted(flatten_state(enc)) == sorted(flat)


@pytest.mark.parametrize("shape", [(5, 48, 40), (3, 2, 16, 24), (96, 40)])
def test_chunked_encode_equals_whole_leaf(shape, monkeypatch):
    """A leaf past ``_CHUNK_ELEMS`` is encoded a chunk of its leading axis
    at a time (a layer stack's own scales; a 2-D table's column absmax
    reduced over the chunks); words and scales equal one whole encode's."""
    from repro_torch.core import lns
    fmt = LNSFormat(8, 8)
    w = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    w[1] *= 64.0   # a chunk with its own range
    r = len(shape)
    whole = lns_weight_encode(w, fmt, scale_axis=tuple(
        i for i in range(r) if i != r - 2))
    monkeypatch.setattr(lns, "_CHUNK_ELEMS", 2 * math.prod(shape[1:]))
    calls = []
    real = lns.lns_encode
    monkeypatch.setattr(lns, "lns_encode", lambda x, *a: (
        calls.append(x.shape[0]), real(x, *a))[1])
    path = ("period", "pos0", "mlp", "up") if r > 2 else ("embed", "tok")
    chunked = lns_leaf_encoder(MadamConfig(update_format=fmt))(path, w)
    assert len(calls) == -(-shape[0] // 2) and max(calls) == 2
    assert torch.equal(chunked.packed, whole.packed)
    assert torch.equal(chunked.scale, whole.scale)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b"])
def test_encode_as_drawn_equals_encode_after(arch):
    """``init_params(leaf_fn=lns_leaf_encoder(...))``, what ``launch.serve``
    and ``init_train_state`` run, gives the tree ``init_lns_params`` gives."""
    cfg = get_smoke_config(arch)
    mcfg = MadamConfig(update_format=LNSFormat(8, 8))
    a = init_lns_params(tm.init_params(cfg, seed=3, device="cpu"), mcfg)
    b = tm.init_params(cfg, seed=3, device="cpu",
                       leaf_fn=lns_leaf_encoder(mcfg))
    la, lb = list(leaves(a)), list(leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        if is_lns_weight(x):
            assert torch.equal(x.packed, y.packed)
            assert torch.equal(x.scale, y.scale)
        else:
            assert torch.equal(x, y)


def _previous_init(cfg, seed):
    """The draws of ``init_params`` before the layer pattern: whole-stack
    truncated normals in the order up, gate, down, tok, wq, wk, wv, wo,
    head."""
    gen = torch.Generator().manual_seed(seed)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def tn(shape, std):
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (std * t).to(cfg.compute_dtype)

    out = {"up": tn((L, d, f), d ** -0.5)}
    if cfg.mlp_gated:
        out["gate"] = tn((L, d, f), d ** -0.5)
    out["down"] = tn((L, f, d), f ** -0.5)
    out["tok"] = tn((cfg.vocab_size, d), 0.02)
    for k, (a, b) in {"wq": (d, h * hd), "wk": (d, kv * hd),
                      "wv": (d, kv * hd), "wo": (h * hd, d)}.items():
        out[k] = tn((L, a, b), a ** -0.5)
    if not cfg.tie_embeddings:
        out["head"] = tn((d, cfg.vocab_size), 0.02)
    return out


@pytest.mark.parametrize("which", ["smollm-smoke", "bert-narrow"])
def test_smollm_and_bert_draws_unchanged(which):
    from repro_torch.configs.paper_models import BERT_BASE
    cfg = get_smoke_config("smollm-135m") if which == "smollm-smoke" else \
        dataclasses.replace(BERT_BASE, num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=4, head_dim=16, d_ff=256,
                            vocab_size=1026)
    want = _previous_init(cfg, seed=0)
    p = tm.init_params(cfg, seed=0, device="cpu")
    blk = p["period"]["pos0"]
    got = dict(blk["mlp"], tok=p["embed"]["tok"], **{
        k: blk["attn"][k] for k in ("wq", "wk", "wv", "wo")})
    if "head" in p["embed"]:
        got["head"] = p["embed"]["head"]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert list(p) == ["embed", "final_norm", "period"]


def test_large_draws_are_made_in_slices(monkeypatch):
    """A draw past ``_DRAW_SLICE_BYTES`` is made a leading slice at a
    time (the f32 temporary stays one slice's size) with the truncated
    normal's statistics."""
    monkeypatch.setattr(tm, "_DRAW_SLICE_BYTES", 4 * 64 * 64)
    shapes = []
    real = tm._draw
    monkeypatch.setattr(tm, "_draw", lambda shape, *a: (
        shapes.append(tuple(shape)), real(shape, *a))[1])
    gen = torch.Generator().manual_seed(0)
    w = tm._trunc_normal((6, 64, 64), 0.5, torch.float32, gen, "cpu")
    assert shapes == [(1, 64, 64)] * 6
    assert w.abs().max() <= 1.0 and abs(float(w.std()) - 0.5 * 0.88) < 0.02


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b"])
def test_remat_is_bit_equal(arch):
    """The smoke train step with remat on and off: loss, grad norm and
    every word after the update equal."""
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import build_train_step, init_train_state
    cfg = get_smoke_config(arch)
    mcfg = MadamConfig()
    b = SyntheticLM(cfg, batch=2, seq=16).batch_at(0)
    outs = []
    for remat in (True, False):
        st = init_train_state(cfg, mcfg, seed=0, device="cpu")
        st, met = build_train_step(cfg, QuantConfig.lns_madam(), mcfg,
                                   remat=remat)(st, b)
        outs.append((st, met))
    (a, ma), (c, mc) = outs
    assert float(ma["loss"]) == float(mc["loss"])
    assert float(ma["grad_norm"]) == float(mc["grad_norm"])
    for (_, x), (_, y) in zip(leaves(a.params), leaves(c.params)):
        if is_lns_weight(x):
            assert torch.equal(x.packed, y.packed)
        else:
            assert torch.equal(x, y)


def test_chunked_quantize_and_regrid_equal_one_pass(monkeypatch):
    """Past ``_CHUNK_ELEMS`` the scales (per tensor, per layer and per
    channel), Q_log and the packed re-grid run a chunk of the leading axis at a time (the 16-bit store's
    forward re-grid and Q_G of gemma3's 1.0e9-element head); the results
    equal one whole pass."""
    from repro_torch.core import lns
    fmt16, fmt8 = LNSFormat(16, 2048), LNSFormat(8, 8)
    x = torch.randn((7, 24, 40), generator=torch.Generator().manual_seed(4))
    x[3] *= 300.0
    words = lns_weight_encode(x, fmt16, scale_axis=(0, 2)).packed

    def run():
        return (lns.compute_scale(x), lns.compute_scale(x, axis=(0, 2)),
                lns.compute_scale(x, axis=2), lns.lns_quantize(x, fmt8),
                lns.lns_quantize(x, fmt8, scale_axis=(0, 2)),
                lns.lns_requant_packed(words, fmt16, fmt8))

    whole = run()
    monkeypatch.setattr(lns, "_CHUNK_ELEMS", 2 * 24 * 40)
    assert len(lns._chunks(x)) == 4
    chunked = run()
    for a, b in zip(whole, chunked):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a 0-d tensor takes the one-pass path
    assert float(lns.compute_scale(torch.tensor(-3.0))) == 4.0
