"""Boundaries of the port: no JAX, no silent CPU, no fallback.

* Importing every ``repro_torch`` module and ``chip_smoke`` loads neither
  ``jax`` nor the JAX package ``repro``.
* The entry points default to CUDA and raise where there is none.
* A CPU tensor takes the plain path and counts no kernel launch; a CUDA
  tensor is routed to the kernel wrapper and can never reach the plain
  version (checked with CUDA unavailable, through stand-in tensors).
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    """No CUDA (hidden here even on a card), or a directory holding only
    the script: non-zero exit and no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(script)], env=env,
                         cwd=script.parent, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


class _CudaStandIn:
    """Claims to be a 2-D CUDA tensor; reshapes to itself."""
    device = torch.device("cuda")
    shape = (2, 4)

    def reshape(self, *shape):
        return self

    def numel(self):
        return 8


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import init_caches, init_params
    from repro_torch.serving import Engine

    cfg = get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_caches(2, 8, cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, QuantConfig.lns_madam(), params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from repro_torch.launch.serve import main
        main(["--smoke"])


def test_training_entry_points_default_to_cuda(no_cuda):
    """``init_train_state``, the train step's first call on a state built
    without a device, and the train CLI without ``--device``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch import train
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import build_train_step, init_train_state

    cfg, mcfg = get_smoke_config("smollm-135m"), MadamConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(cfg, mcfg)
    step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step(init_train_state(cfg, mcfg), {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


def _cpu_args():
    rng = np.random.default_rng(0)
    fmt = LNSFormat(8, 8)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    pa, sa = ref.encode_pack(x, fmt)
    pb = torch.from_numpy(rng.integers(0, 256, (32, 8), dtype=np.uint8))
    q = torch.randn(2, 1, 4, 32)
    pool = torch.randn(5, 4, 2, 32)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ln = torch.tensor([3, 8], dtype=torch.int32)
    w16 = torch.from_numpy(rng.integers(0, 1 << 16, (6, 10)).astype(np.int32))
    g, v = torch.randn(6, 10), torch.rand(6, 10)
    f16 = LNSFormat(16, 2048)
    madam = dict(lr=2.0 ** -7, beta=0.999, eps=1e-30)
    return {
        "encode_pack": ((x, fmt), {}),
        "qmatmul": ((pa, pb, fmt, sa), {"compute_dtype": torch.float32}),
        "paged_attend": ((q, pool, pool, None, None, bt, ln),
                         {"sm_scale": 0.25}),
        "fused_sample": ((torch.randn(2, 50), None, None), {}),
        "madam_step": ((w16, g, v, 0.5, f16), madam),
        "madam_step_stats": ((w16, g, v, 0.5, f16), dict(madam, requant=None)),
    }


def _dispatch_call(name, args, kw):
    """Call the dispatch entry behind kernel ``name`` with its wrapper's
    arguments (the Madam step's dispatch takes a step count, not bc)."""
    if name.startswith("madam_step"):
        w, g, v, _, fmt = args
        return dispatch.madam_step(w, g, v, 3, fmt, lr=kw["lr"],
                                   with_stats=name == "madam_step_stats")
    return getattr(dispatch, name)(*args, **kw)


def test_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    for name, (args, kw) in _cpu_args().items():
        _dispatch_call(name, args, kw)
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}


def test_cuda_tensors_never_reach_plain_path(no_cuda, monkeypatch):
    """With the CUDA check off, stand-ins whose device is CUDA go to the
    kernel wrappers; the plain versions are rigged to fail if reached."""
    called = []
    cuda = _CudaStandIn()

    def kernel(name):
        def fn(*a, **k):
            called.append(name)
            if name == "madam_step":
                return cuda, cuda
            return cuda, cuda, torch.zeros(8, dtype=torch.float64)
        return fn

    for name in ops.KERNELS:
        monkeypatch.setattr(ref, name, lambda *a, _n=name, **k: pytest.fail(
            f"plain {_n} reached from a CUDA tensor"))
        monkeypatch.setattr(ops, name, kernel(name))
    dispatch.encode_pack(cuda, LNSFormat())
    dispatch.qmatmul(cuda, cuda, LNSFormat())
    dispatch.paged_attend(cuda, cuda, cuda, None, None, cuda, cuda,
                          sm_scale=1.0)
    dispatch.fused_sample(cuda, None, None)
    dispatch.madam_step(cuda, cuda, cuda, 1, LNSFormat(16, 2048), lr=0.01)
    dispatch.madam_step(cuda, cuda, cuda, 1, LNSFormat(16, 2048), lr=0.01,
                        with_stats=True)
    assert called == list(ops.KERNELS)
    with pytest.raises(ValueError, match="no kernel path"):
        dispatch.route(torch.empty(1, device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers themselves never compute on the CPU."""
    for name, (args, kw) in _cpu_args().items():
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            getattr(ops, name)(*args, **kw)
