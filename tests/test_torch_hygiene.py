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
        "qmatmul_decode": ((pa, pb, fmt), {}),
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
    dispatch.qmatmul_decode(cuda, cuda, LNSFormat())
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
    # a meta tensor takes the shape functions (a dry run), any other
    # device raises
    assert dispatch.route(torch.empty(1, device="meta")) == "meta"
    with pytest.raises(ValueError, match="no kernel path"):
        dispatch.route(types.SimpleNamespace(device=torch.device("mps")))


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


@pytest.mark.parametrize("shape,axis,fmt,match", [
    ((4, 8), 1, (8, 8), "scale_axis"),
    ((4, 8), (0, 1), (8, 8), "scale_axis"),
    ((0, 8), None, (8, 8), "non-empty"),
    ((4, 8), None, (16, 2048), "bits <= 8"),
])
def test_k1_wrapper_refuses_what_it_cannot_take(shape, axis, fmt, match):
    """K1 takes a non-empty 2-D f32 or bf16 x, scaled per tensor or per
    row, into byte words."""
    x = _cuda_words(torch.bfloat16, shape)
    with pytest.raises(ValueError, match=match):
        ops.encode_pack(x, LNSFormat(*fmt), axis)
    with pytest.raises(ValueError, match="not in"):
        ops.encode_pack(_cuda_words(torch.int32), LNSFormat(8, 8))


def test_k8_wrapper_refuses_more_row_tiles_than_a_grid_takes():
    pa = _cuda_words(torch.uint8, (128 * 65535 + 1, 8))
    with pytest.raises(ValueError, match="row tiles"):
        ops.lns_matmul_packed(pa, _cuda_words(torch.uint8, (8, 4)),
                              LNSFormat(8, 8))


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


@pytest.mark.parametrize("name", ["qmatmul", "qmatmul_decode",
                                  "paged_attend", "encode_pack",
                                  "lns_matmul_packed"])
def test_redesigned_wrappers_refuse_cpu_tensors(name, monkeypatch):
    """K2 (and its decode pass), K5, K1 and K8 take CUDA tensors only,
    whatever path K2's or K8's plan picks and whichever K1 scale."""
    args, kw = _cpu_args()[name]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        getattr(ops, name)(*args, **kw)
    if name == "encode_pack":
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            ops.encode_pack(*args, scale_axis=0)
    if name == "lns_matmul_packed":
        for skinny_m in (0, 1 << 62):          # wide or mid, then skinny
            monkeypatch.setattr(ops, "_K8_SKINNY_M", skinny_m)
            with pytest.raises(ValueError, match="expected a CUDA tensor"):
                ops.lns_matmul_packed(*args, **kw)
    if name == "qmatmul":
        for threshold in (0, 1 << 62):       # wgmma, then skinny
            monkeypatch.setattr(ops, "QMATMUL_WGMMA_MIN_M", threshold)
            with pytest.raises(ValueError, match="expected a CUDA tensor"):
                ops.qmatmul(*args, **dict(kw, compute_dtype=torch.bfloat16))


@pytest.mark.parametrize("out_dtype", [torch.float16, torch.int32,
                                       torch.float64])
def test_k2_wrapper_refuses_other_out_dtypes(out_dtype):
    """K2 rounds its output to f32 or bf16 only."""
    pa, pb = _cuda_words(torch.uint8, (4, 8)), _cuda_words(torch.uint8,
                                                           (8, 4))
    with pytest.raises(ValueError, match="out_dtype"):
        ops.qmatmul(pa, pb, LNSFormat(8, 8), out_dtype=out_dtype)


def _host_rows(B, temp=np.float32, seed=np.uint32, step=np.int32):
    return (np.ones(B, temp), np.arange(B).astype(seed),
            np.zeros(B, step))


@pytest.mark.parametrize("bad,match", [
    (dict(temp=np.float64), "temp"),
    (dict(seed=np.int64), "seed"),
    (dict(step=np.int64), "step"),
])
def test_k6_seeded_wrapper_refuses_wrong_row_dtypes(bad, match):
    """K6's seeded rows go by value into the launch as f32 temp, uint32
    seed and int32 step: anything else is refused before a launch."""
    lg = _cuda_words(torch.float32, (4, 50))
    with pytest.raises(ValueError, match=match):
        ops.fused_sample_seeded(lg, *_host_rows(4, **bad))
    with pytest.raises(ValueError, match="temp"):
        ops.fused_sample_seeded(lg, torch.ones(4), *_host_rows(4)[1:])
    with pytest.raises(ValueError, match="not in"):
        ops.fused_sample_seeded(_cuda_words(torch.bfloat16, (4, 50)),
                                *_host_rows(4))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.fused_sample_seeded(torch.zeros(4, 50), *_host_rows(4))


def test_k6_seeded_wrapper_refuses_more_rows_than_a_launch_holds():
    B = ops.K6_MAX_ROWS + 1
    with pytest.raises(ValueError, match=f"at most {ops.K6_MAX_ROWS} rows"):
        ops.fused_sample_seeded(_cuda_words(torch.float32, (B, 50)),
                                *_host_rows(B))


def test_sample_logits_splits_batches_over_the_row_limit(monkeypatch):
    """A batch of more rows than K6's seeded launch holds goes in launches
    of at most ``K6_MAX_ROWS`` rows, and samples as one batch would."""
    from repro_torch.server.sampling import sample_logits, sampling_rows
    B = ops.K6_MAX_ROWS + 6
    rows = sampling_rows(B)
    rows["temp"][:] = 0.9
    rows["seed"][:] = np.arange(B)
    sizes = []
    seeded = dispatch.fused_sample_seeded

    def record(lg, *a, **k):
        sizes.append(lg.shape[0])
        return seeded(lg, *a, **k)

    monkeypatch.setattr(dispatch, "fused_sample_seeded", record)
    lg = torch.randn(B, 30, generator=torch.Generator().manual_seed(0))
    toks = sample_logits(lg, rows)
    assert sizes == [ops.K6_MAX_ROWS, 6]
    assert torch.equal(toks, ref.fused_sample_seeded(
        lg, rows["temp"], rows["seed"], rows["step"]))


def _cuda_leaf(n=64, dtype=torch.uint8):
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 is_contiguous=lambda: True,
                                 numel=lambda: n)


def test_k7_grouped_wrapper_refuses_what_one_launch_cannot_take():
    """At most ``K7_MAX_LEAVES`` leaves (the by-value table), at least
    one, all uint8 on the card, sharing one (src, dst)."""
    fmt = LNSFormat(8, 8)
    six = fmt.with_bits(6)
    with pytest.raises(ValueError, match=f"1..{ops.K7_MAX_LEAVES} leaves"):
        ops.requant_pack_many([_cuda_leaf()] * (ops.K7_MAX_LEAVES + 1), fmt,
                              six)
    with pytest.raises(ValueError, match="1..16 leaves"):
        ops.requant_pack_many([], fmt, six)
    with pytest.raises(ValueError, match="not uint8"):
        ops.requant_pack_many([_cuda_leaf(), _cuda_leaf(dtype=torch.int32)],
                              fmt, six)
    with pytest.raises(ValueError, match="share one"):
        ops.requant_pack_many([_cuda_leaf()] * 2, [fmt, LNSFormat(8, 16)],
                              six)
    with pytest.raises(ValueError, match="share one"):
        ops.requant_pack_many([_cuda_leaf()] * 2, fmt, [six, fmt.with_bits(7)])
    with pytest.raises(ValueError, match="share one"):
        ops.requant_pack_many([_cuda_leaf()] * 2, fmt, [six])
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.requant_pack_many([_cuda_leaf(), torch.zeros(4, dtype=torch.uint8)],
                              fmt, six)


def test_new_dispatch_entries_never_reach_plain_path(no_cuda, monkeypatch):
    """The seeded K6 and the grouped K7 route CUDA stand-ins to their
    wrappers; leaves on two kinds of device are refused, not split."""
    called = []
    cuda = _CudaStandIn()
    for name in ("fused_sample_seeded", "requant_pack_many"):
        monkeypatch.setattr(ref, name, lambda *a, _n=name, **k: pytest.fail(
            f"plain {_n} reached from a CUDA tensor"))
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **k:
                            called.append(_n))
    dispatch.fused_sample_seeded(cuda, *_host_rows(2), noise_out=True)
    dispatch.requant_pack_many([cuda, cuda], LNSFormat(8, 8),
                               LNSFormat(6, 2))
    assert called == ["fused_sample_seeded", "requant_pack_many"]
    with pytest.raises(ValueError, match="one kind of device"):
        dispatch.requant_pack_many([torch.zeros(3, dtype=torch.uint8), cuda],
                                   LNSFormat(8, 8), LNSFormat(6, 2))
    with pytest.raises(ValueError, match="one kind of device"):
        dispatch.requant_pack_many([], LNSFormat(8, 8), LNSFormat(6, 2))
