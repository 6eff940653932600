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
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke"])


def test_spec_entry_points_default_to_cuda(no_cuda):
    """The speculative engine and ``serve --speculate-k`` without a device
    (the draft views would run K7 there)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.serve import main
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine

    cfg = get_smoke_config("smollm-135m")
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, QuantConfig.lns_madam(), params, speculate_k=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--speculate-k", "2", "--page-size", "4",
              "--alloc-policy", "ondemand"])


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
    code16 = torch.from_numpy(rng.integers(0, 1 << 15, (6, 10)).astype(
        np.int16))
    sign = torch.from_numpy(np.where(rng.random((6, 10)) < 0.5, 1, -1
                                     ).astype(np.int8))
    return {
        "encode_pack": ((x, fmt), {}),
        "qmatmul": ((pa, pb, fmt, sa), {"compute_dtype": torch.float32}),
        "paged_attend": ((q, pool, pool, None, None, bt, ln),
                         {"sm_scale": 0.25}),
        "fused_sample": ((torch.randn(2, 50), None, None), {}),
        "madam_step": ((w16, g, v, 0.5, f16), madam),
        "madam_step_stats": ((w16, g, v, 0.5, f16), dict(madam, requant=None)),
        "requant_pack": ((pb, fmt, fmt.with_bits(6)), {}),
        "lns_matmul_packed": ((pa, pb, fmt), {"lut_entries": 2}),
        "madam_step_unpacked": ((code16, sign, g, v, 0.5, f16), madam),
    }


def _dispatch_call(name, args, kw):
    """Call the dispatch entry behind kernel ``name`` with its wrapper's
    arguments (the Madam steps' dispatch takes a step count, not bc)."""
    if name == "madam_step_unpacked":
        code, sign, g, v, _, fmt = args
        return dispatch.madam_step_unpacked(code, sign, g, v, 3, fmt,
                                            lr=kw["lr"])
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
            if name == "lns_matmul_packed":
                return cuda
            if name in ("madam_step", "madam_step_unpacked"):
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
    dispatch.requant_pack(cuda, LNSFormat(8, 8), LNSFormat(6, 2))
    dispatch.lns_matmul_packed(cuda, cuda, LNSFormat(8, 8), lut_entries=4)
    dispatch.madam_step_unpacked(cuda, cuda, cuda, cuda, 1,
                                 LNSFormat(16, 2048), lr=0.01)
    assert called == list(ops.KERNELS)
    with pytest.raises(ValueError, match="no kernel path"):
        dispatch.route(torch.empty(1, device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers themselves never compute on the CPU."""
    for name, (args, kw) in _cpu_args().items():
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            getattr(ops, name)(*args, **kw)


@pytest.mark.parametrize("dtype,fmts,match", [
    (torch.int32, ((8, 8), (6, 2)), "not uint8"),
    (torch.uint8, ((16, 2048), (8, 8)), "bits <= 8"),
    (torch.uint8, ((8, 8), (16, 2048)), "bits <= 8"),
])
def test_requant_wrapper_refuses_words_it_cannot_take(dtype, fmts, match):
    """K7's wrapper takes contiguous uint8 words of at most 8 bits."""
    words = types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                  is_contiguous=lambda: True)
    src, dst = (LNSFormat(*f) for f in fmts)
    with pytest.raises(ValueError, match=match):
        ops.requant_pack(words, src, dst)


def _cuda_words(dtype, shape=(4, 8)):
    """A stand-in for a contiguous 2-D CUDA tensor of ``dtype``."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 shape=torch.Size(shape),
                                 dim=lambda: len(shape),
                                 is_contiguous=lambda: True)


@pytest.mark.parametrize("fmt,kw,match", [
    ((16, 2048), {}, "bits <= 8"),
    ((8, 8192), {}, "gamma <= 4096"),
    ((8, 8), {"frac_bits": 20}, "frac_bits"),
    ((8, 8), {"block_k": 0}, "block_k"),
    ((8, 8), {"block_k": 8192}, "block_k"),
])
def test_k8_wrapper_refuses_what_it_cannot_take(fmt, kw, match):
    """K8 takes byte words, and bounds gamma, frac_bits and block_k so no
    int32 product or block sum can overflow in the kernel."""
    pa, pb = _cuda_words(torch.uint8, (4, 8)), _cuda_words(torch.uint8,
                                                           (8, 4))
    with pytest.raises(ValueError, match=match):
        ops.lns_matmul_packed(pa, pb, LNSFormat(*fmt), **kw)
    with pytest.raises(ValueError, match="not in"):
        ops.lns_matmul_packed(_cuda_words(torch.int32), pb, LNSFormat(8, 8))


@pytest.mark.parametrize("code_dt,fmt,match", [
    (torch.int8, (8, 8), "not in"),
    (torch.uint8, (16, 2048), "2..8-bit"),
    (torch.int16, (17, 4096), "2..16-bit"),
])
def test_k9_wrapper_refuses_what_it_cannot_take(code_dt, fmt, match):
    """K9 takes uint8 codes up to B=8, int16 or int32 codes up to B=16."""
    code = _cuda_words(code_dt)
    with pytest.raises(ValueError, match=match):
        ops.madam_step_unpacked(code, _cuda_words(torch.int8),
                                _cuda_words(torch.float32),
                                _cuda_words(torch.float32), 0.5,
                                LNSFormat(*fmt), lr=0.01, beta=0.999,
                                eps=1e-30)
