"""Wrappers that launch the hand-written CUDA kernels on CUDA tensors.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch was refused (the C entry point returns
``cudaGetLastError()``), and then adds one to its kernel's ``launches``
count. It never falls back to the plain version: a tensor it cannot take
raises. The kernels build on first launch (``_build.library``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import conversion
from repro_torch.core.lns import LNSFormat
from repro_torch.kernels import _build, ref

__all__ = ["Kernel", "KERNELS", "ENCODE_PACK", "QMATMUL", "QMATMUL_DECODE",
           "PAGED_ATTEND", "PAGED_ATTEND_HEAD_DIMS", "QMATMUL_WGMMA_MIN_M",
           "qmatmul_plan",
           "arith_decode", "K6_MAX_ROWS", "K7_MAX_LEAVES", "fused_sample_plan",
           "regrid_shift",
           "FUSED_SAMPLE", "MADAM_STEP", "MADAM_STEP_STATS", "REQUANT_PACK",
           "LNS_MATMUL_PACKED", "MADAM_STEP_UNPACKED", "launch_counts",
           "reset_launch_counts", "lns_matmul_plan", "encode_pack",
           "qmatmul", "qmatmul_decode", "paged_attend",
           "fused_sample", "fused_sample_seeded", "madam_step",
           "madam_step_stats", "requant_pack", "requant_pack_many",
           "lns_matmul_packed", "madam_step_unpacked"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3,
       torch.int32: 4, torch.int16: 5}


class Kernel:
    """One C entry point of the kernel library plus its launch count."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_build.library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err}")
        self.launches += 1


ENCODE_PACK = Kernel("encode_pack", "repro_encode_pack",
                     [_P, _I, _I, _P, _P, _P, _LL, _LL, _I, _I, _I, _LL,
                      _LL, _P])
QMATMUL = Kernel("qmatmul", "repro_qmatmul",
                 [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _I, _P])
QMATMUL_DECODE = Kernel("qmatmul_decode", "repro_qmatmul_decode",
                        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
PAGED_ATTEND = Kernel("paged_attend", "repro_paged_attend",
                      [_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P])
FUSED_SAMPLE = Kernel("fused_sample", "repro_fused_sample",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
_MADAM_ARGS = [_P, _I, _P, _I, _P, _P, _P, _LL, _I, _I, _F, _F, _F, _F, _F]
MADAM_STEP = Kernel("madam_step", "repro_madam_step", _MADAM_ARGS + [_I, _P])
MADAM_STEP_STATS = Kernel("madam_step_stats", "repro_madam_step_stats",
                          _MADAM_ARGS + [_I, _I, _P, _I, _P])
_LLP = ctypes.POINTER(_LL)
REQUANT_PACK = Kernel("requant_pack", "repro_requant_pack",
                      [_LLP, _LLP, _LLP, _I, _I, _I, _I, _I, _I, _P])
LNS_MATMUL_PACKED = Kernel("lns_matmul_packed", "repro_lns_matmul",
                           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P])
MADAM_STEP_UNPACKED = Kernel("madam_step_unpacked",
                             "repro_madam_step_unpacked",
                             [_P, _I, _P, _P, _I, _P, _P, _P, _LL, _I, _I,
                              _F, _F, _F, _F, _F, _I, _P])
KERNELS: Dict[str, Kernel] = {k.name: k for k in
                              (ENCODE_PACK, QMATMUL, QMATMUL_DECODE,
                               PAGED_ATTEND,
                               FUSED_SAMPLE, MADAM_STEP, MADAM_STEP_STATS,
                               REQUANT_PACK, LNS_MATMUL_PACKED,
                               MADAM_STEP_UNPACKED)}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_fmt(fmt: LNSFormat) -> None:
    if fmt.bits > 8:
        raise ValueError(f"the kernels take byte words (bits <= 8), got {fmt}")


_FLOATS = (torch.float32, torch.bfloat16)
# K1 per tensor: threads a block; one block (no grid barrier) up to
# _K1_ONE_BLOCK elements, above that a block a _K1_MIN_CHUNK elements up to
# one a SM. From `chip_smoke.py --k1-sweep` (PERF.md); read when the
# wrapper is called
_K1_THREADS = 512
_K1_ONE_BLOCK = 8192
_K1_MIN_CHUNK = 2048


def encode_pack(x: torch.Tensor, fmt: LNSFormat,
                scale_axis: Optional[int] = None,
                scale: Optional[torch.Tensor] = None):
    """K1 on the card -> ``(packed uint8 (R,C), scale (R,1) f32)``: the
    pow2 absmax scale (per tensor, or per row for ``scale_axis=0``) and the
    words in one launch; no torch op runs besides the two allocations.
    With ``scale`` (f32 ``(1, 1)`` per tensor, ``(R, 1)`` per row) the
    kernel skips its absmax pass and encodes against it, still one
    launch: a data-parallel rank's scale is the global batch's."""
    _check(x, "x", _FLOATS, 2)
    _check_fmt(fmt)
    if scale_axis not in (None, 0):
        raise ValueError(f"K1 scales per tensor or per row (scale_axis None "
                         f"or 0), got scale_axis={scale_axis}")
    R, C = x.shape
    if R * C == 0:
        raise ValueError(f"K1 takes a non-empty x, got {tuple(x.shape)}")
    given = 0
    if scale is not None:
        if scale.device != x.device:
            raise ValueError(f"scale: on {scale.device}, x on {x.device}")
        given = _scale_ptr(scale, (1, 1) if scale_axis is None else (R, 1),
                           "scale")
    out = torch.empty((R, C), dtype=torch.uint8, device=x.device)
    srow = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    ENCODE_PACK(x.data_ptr(), _DT[x.dtype], int(scale_axis == 0), given,
                out.data_ptr(), srow.data_ptr(), R, C, fmt.bits, fmt.gamma,
                _K1_THREADS, _K1_ONE_BLOCK, _K1_MIN_CHUNK, _stream(x))
    return out, srow


def _scale_ptr(s: Optional[torch.Tensor], shape, name: str) -> int:
    if s is None:
        return 0
    _check(s, name, (torch.float32,), 2)
    if tuple(s.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(s.shape)}")
    return s.data_ptr()


# K2's plan. The skinny path's unit of work is one 16-deep K step of 32
# columns for one warp (a 4-byte load of each of 16 weight rows). Where eight
# warps can share all of K at <= _SK_ONE_STEPS steps each, one 8-warp block
# takes it (no split-K: at K=576 the split's extra round trip cost more
# than the parallelism it buys); deeper K splits over the grid in 4-warp
# blocks of _SK_SPLIT_STEPS-step warps. Both constants come from
# `chip_smoke.py --k2-sweep` (PERF.md). M >= QMATMUL_WGMMA_MIN_M takes the
# wgmma path (the crossover measured by chip_smoke.py, PERF.md). The plan
# reads all three when it is called.
_SK_ONE_STEPS = 6
_SK_SPLIT_STEPS = 3
_SK_NW = 32
QMATMUL_WGMMA_MIN_M = 256
_PATHS = ("skinny", "wgmma", "f32")


def qmatmul_plan(M: int, N: int, K: int,
                 compute_dtype=torch.bfloat16) -> Dict[str, int]:
    """K2's launch plan for ``(M,K) @ (K,N)``: the path (``"skinny"``,
    ``"wgmma"`` or ``"f32"``), its grid size in blocks (the GEMM's, on
    the wgmma path), and on the skinny path the split-K ``splits``,
    ``steps`` (16-deep K steps a warp), ``warps`` a block (8, or 4 where
    K splits) and 8-row activation tiles a block (``mt8``: 1 or 2)."""
    if compute_dtype == torch.float32:
        return dict(path="f32", blocks=-(-N // 64) * -(-M // 16), splits=1,
                    steps=0, warps=0, mt8=0)
    if M >= QMATMUL_WGMMA_MIN_M:
        return dict(path="wgmma", blocks=-(-N // 128) * -(-M // 128),
                    splits=1, steps=0, warps=0, mt8=0)
    mt8 = 1 if M <= 8 else 2                     # 8-row tiles a block
    ntiles, ksteps, mtiles = -(-N // _SK_NW), -(-K // 16), -(-M // (8 * mt8))
    warps, steps = 8, -(-ksteps // 8)
    if steps > _SK_ONE_STEPS:
        warps, steps = 4, _SK_SPLIT_STEPS
    splits = -(-ksteps // (warps * steps))
    return dict(path="skinny", blocks=ntiles * splits * mtiles,
                splits=splits, steps=steps, warps=warps, mt8=mt8)


def arith_decode(fmt: LNSFormat) -> bool:
    """Whether K2's skinny path decodes by ALU (``Dec`` in lns_qmatmul.cu)
    rather than through the shared-memory table: gamma <= 8, and every
    code's bf16 value is a normal number (at most 125 exponent steps below
    the base value's)."""
    lg = fmt.gamma.bit_length() - 1
    return fmt.gamma <= 8 and (fmt.max_code >> lg) <= 125


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def qmatmul_decode(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat):
    """K2's decode pass on the card (the wgmma path's first kernel): packed
    operands -> padded K-major bf16 ``(ad (Mp,Kp), bt (Np,Kp))``, as
    ``ref.qmatmul_decode``; both views of one buffer, ``bt`` right after
    ``ad``."""
    _check(pa, "pa", (torch.uint8,), 2)
    _check(pb, "pb", (torch.uint8,), 2)
    _check_fmt(fmt)
    (M, K), N = pa.shape, pb.shape[1]
    if pb.shape[0] != K:
        raise ValueError(f"inner dims differ: {tuple(pa.shape)} @ "
                         f"{tuple(pb.shape)}")
    mp, np_, kp = (-(-M // ref.WG_MN) * ref.WG_MN,
                   -(-N // ref.WG_MN) * ref.WG_MN, -(-K // ref.WG_K) * ref.WG_K)
    ws = torch.empty(((mp + np_) * kp,), dtype=torch.bfloat16,
                     device=pa.device)
    QMATMUL_DECODE(pa.data_ptr(), pb.data_ptr(), ws.data_ptr(), M, N, K,
                   fmt.bits, fmt.gamma, int(_aligned(pa, pb)), _stream(pa))
    return ws[:mp * kp].view(mp, kp), ws[mp * kp:].view(np_, kp)


def qmatmul(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat,
            scale_a: Optional[torch.Tensor] = None,
            scale_b: Optional[torch.Tensor] = None, *,
            compute_dtype=torch.bfloat16,
            out_dtype=torch.float32) -> torch.Tensor:
    """K2 on the card: packed ``(M,K) @ (K,N)`` with scales -> ``out_dtype``
    (f32 or bf16, rounded once from the scaled f32 sum), through the path
    :func:`qmatmul_plan` picks. The skinny and f32 paths launch one kernel;
    the wgmma path launches :func:`qmatmul_decode` (counted as
    ``qmatmul_decode``), then its GEMM (counted as ``qmatmul``)."""
    _check(pa, "pa", (torch.uint8,), 2)
    _check(pb, "pb", (torch.uint8,), 2)
    _check_fmt(fmt)
    if compute_dtype not in _FLOATS:
        raise ValueError(f"compute_dtype {compute_dtype} not in {_FLOATS}")
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    M, K = pa.shape
    K2, N = pb.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(pa.shape)} @ "
                         f"{tuple(pb.shape)}")
    pa_s = _scale_ptr(scale_a, (M, 1), "scale_a")
    pb_s = _scale_ptr(scale_b, (1, N), "scale_b")
    plan = qmatmul_plan(M, N, K, compute_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=pa.device)
    aligned = _aligned(pa, pb)
    ws = None
    if plan["path"] == "skinny":
        aligned = aligned and N % 4 == 0 and K % 4 == 0
        if plan["splits"] > 1:
            ws = torch.empty((plan["splits"], M, N), dtype=torch.float32,
                             device=pa.device)
    elif plan["path"] == "wgmma":
        pa, pb = qmatmul_decode(pa, pb, fmt)   # the GEMM's operands
    QMATMUL(pa.data_ptr(), pb.data_ptr(), pa_s, pb_s, out.data_ptr(),
            _DT[out_dtype], 0 if ws is None else ws.data_ptr(), M, N, K,
            fmt.bits, fmt.gamma, _PATHS.index(plan["path"]), plan["splits"],
            plan["steps"], plan["warps"], plan["mt8"], int(aligned),
            int(arith_decode(fmt)), _stream(out))
    return out


# K5 stages pages in dynamic shared memory, two stages a warp where they fit
# an H100 block's 227 KB, else one (the kernel reports the bytes)
_SMEM_MAX = 232448
# the head_dims K5 is instantiated for (paged_attend.cu's switch)
PAGED_ATTEND_HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)


def paged_attend(q, kp, vp, k_scale, v_scale, block_table, lengths, *,
                 fmt: Optional[LNSFormat] = None,
                 softcap: Optional[float] = None,
                 sm_scale: float) -> torch.Tensor:
    """K5 on the card: paged GQA attention -> f32 ``(B,S,h,hd)``. The
    head_dim must be one of ``PAGED_ATTEND_HEAD_DIMS`` (checked first,
    from the shapes alone)."""
    hd = q.shape[-1]
    if hd not in PAGED_ATTEND_HEAD_DIMS:
        raise ValueError(f"paged_attend: head_dim {hd} is not one of the "
                         f"supported head_dims {PAGED_ATTEND_HEAD_DIMS}")
    _check(q, "q", _FLOATS, 4)
    B, S, H, hd = q.shape
    pool_dt = (torch.uint8,) if fmt is not None else _FLOATS
    _check(kp, "kp", pool_dt, 4)
    _check(vp, "vp", pool_dt, 4)
    if vp.shape != kp.shape or kp.dtype != vp.dtype:
        raise ValueError("kp and vp must share shape and dtype")
    _, page, KV, hd2 = kp.shape
    if hd2 != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(kp.shape)}: "
                         f"need equal head_dims and KV | H")
    smem_fn = _build.library().repro_paged_attend_smem
    smem_fn.argtypes, smem_fn.restype = [_I, _I, _I, _I], ctypes.c_longlong
    nbuf = 2 if smem_fn(hd, _DT[kp.dtype], page, 2) <= _SMEM_MAX else 1
    smem = smem_fn(hd, _DT[kp.dtype], page, nbuf)
    if smem > _SMEM_MAX:
        raise ValueError(f"page {page} x head_dim {hd} needs {smem} bytes of "
                         f"shared memory, more than the card's {_SMEM_MAX}")
    _check(block_table, "block_table", (torch.int32,), 2)
    _check(lengths, "lengths", (torch.int32,), 1)
    if block_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("block_table and lengths need one row per batch row")
    ks_p = vs_p = 0
    s_dt = 0
    bits, gamma = 8, 1
    if fmt is not None:
        _check_fmt(fmt)
        bits, gamma = fmt.bits, fmt.gamma
        for s, n in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            _check(s, n, _FLOATS, 4)
            if tuple(s.shape) != (kp.shape[0], page, KV, 1):
                raise ValueError(f"{n}: expected (P, page, KV, 1), got "
                                 f"{tuple(s.shape)}")
        if k_scale.dtype != v_scale.dtype:
            raise ValueError("k_scale and v_scale must share a dtype")
        ks_p, vs_p, s_dt = k_scale.data_ptr(), v_scale.data_ptr(), \
            _DT[k_scale.dtype]
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    PAGED_ATTEND(q.data_ptr(), _DT[q.dtype], kp.data_ptr(), vp.data_ptr(),
                 _DT[kp.dtype], ks_p, vs_p, s_dt, block_table.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, S, H, KV, hd, page,
                 block_table.shape[1], bits, gamma,
                 0.0 if softcap is None else float(softcap), float(sm_scale),
                 nbuf, _stream(q))
    return out


# K6's plan: a row is split over a cluster of up to _K6_MAX_BLOCKS blocks
# (a power of two), each with at least _K6_MIN_CHUNK logits and at most
# _K6_FILL blocks in all; _K6_THREADS threads a block. From `chip_smoke.py
# --k6-sweep` (PERF.md); the plan reads them when it is called.
_K6_THREADS = 256
_K6_MAX_BLOCKS = 16
_K6_MIN_CHUNK = 2048
_K6_FILL = 2 * 132
# the seeded mode's per-row arguments travel by value in the launch
# (sampler.cu `SampleRows`): at most this many rows a launch
K6_MAX_ROWS = 64


class _SampleRows(ctypes.Structure):
    _fields_ = [("temp", ctypes.c_float * K6_MAX_ROWS),
                ("seed", ctypes.c_uint32 * K6_MAX_ROWS),
                ("step", ctypes.c_int32 * K6_MAX_ROWS)]


def fused_sample_plan(B: int, V: int) -> Dict[str, int]:
    """K6's launch: ``blocks`` a row (the cluster size) and ``threads`` a
    block, for a ``(B, V)`` batch."""
    blocks = 1
    while (2 * blocks <= _K6_MAX_BLOCKS and V >= 2 * blocks * _K6_MIN_CHUNK
           and 2 * blocks * B <= _K6_FILL):
        blocks *= 2
    return dict(blocks=blocks, threads=_K6_THREADS)


def _k6_launch(logits, g_p, t_p, rows, noise_out):
    B, V = logits.shape
    plan = fused_sample_plan(B, V)
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    FUSED_SAMPLE(logits.data_ptr(), g_p, t_p,
                 0 if rows is None else ctypes.addressof(rows),
                 0 if noise_out is None else noise_out.data_ptr(),
                 out.data_ptr(), B, V, plan["blocks"], plan["threads"],
                 _stream(logits))
    return out


def fused_sample(logits: torch.Tensor, gumbel: Optional[torch.Tensor],
                 temp: Optional[torch.Tensor]) -> torch.Tensor:
    """K6 on the card: ``(B, V)`` f32 logits -> ``(B,)`` int32 tokens,
    greedy, or with the noise ``gumbel (B, V)`` fed in and a device
    ``temp (B,)`` (the TPU kernel's function)."""
    _check(logits, "logits", (torch.float32,), 2)
    B, V = logits.shape
    g_p = t_p = 0
    if gumbel is not None:
        _check(gumbel, "gumbel", (torch.float32,), 2)
        _check(temp, "temp", (torch.float32,), 1)
        if tuple(gumbel.shape) != (B, V) or temp.shape[0] != B:
            raise ValueError("gumbel must be (B, V) and temp (B,)")
        g_p, t_p = gumbel.data_ptr(), temp.data_ptr()
    return _k6_launch(logits, g_p, t_p, None, None)


_SEEDED_ROWS = (("temp", np.float32), ("seed", np.uint32), ("step", np.int32))


def fused_sample_seeded(logits: torch.Tensor, temp: np.ndarray,
                        seed: np.ndarray, step: np.ndarray, *,
                        noise_out: bool = False):
    """K6 on the card, seeded: ``(B, V)`` f32 logits and host rows ``temp``
    (f32), ``seed`` (uint32) and ``step`` (int32) -> ``(B,)`` int32
    tokens, the noise drawn in the kernel from (seed, step, token id) as
    ``ref.gumbel_noise`` draws it; with ``noise_out`` also that noise
    ``(B, V)`` f32 for every row. The rows go by value in the launch, so
    at most :data:`K6_MAX_ROWS` rows a call."""
    _check(logits, "logits", (torch.float32,), 2)
    B, V = logits.shape
    if B > K6_MAX_ROWS:
        raise ValueError(f"K6's seeded mode takes at most {K6_MAX_ROWS} rows "
                         f"a launch, got {B}")
    rows = _SampleRows()
    for (name, dt), a in zip(_SEEDED_ROWS, (temp, seed, step)):
        if not isinstance(a, np.ndarray) or a.dtype != dt or a.shape != (B,):
            raise ValueError(f"{name}: expected a ({B},) {np.dtype(dt)} host "
                             f"array, got {getattr(a, 'dtype', type(a))} "
                             f"{getattr(a, 'shape', '')}")
        getattr(rows, name)[:B] = a.tolist()
    noise = (torch.empty((B, V), dtype=torch.float32, device=logits.device)
             if noise_out else None)
    out = _k6_launch(logits, 0, 0, rows, noise)
    return (out, noise) if noise_out else out


# K3/K4 launch geometry: 256 threads, enough blocks to fill the 132 SMs
# twice over, then a grid-stride loop (K4 writes one stat row per block)
_MADAM_THREADS = 256
_MADAM_MAX_BLOCKS = 132 * 16


def _madam_blocks(n: int) -> int:
    return max(1, min(-(-n // _MADAM_THREADS), _MADAM_MAX_BLOCKS))


def _madam_check(packed, g, v, fmt: LNSFormat):
    if not 2 <= fmt.bits <= 16:
        raise ValueError(f"the Madam kernels take words of 2..16 bits, got "
                         f"{fmt}")
    word_dt = torch.uint8 if fmt.bits <= 8 else torch.int32
    _check(packed, "packed", (word_dt,), 2)
    _check(g, "g", _FLOATS, 2)
    _check(v, "v", (torch.float32,), 2)
    if g.shape != packed.shape or v.shape != packed.shape:
        raise ValueError(f"packed {tuple(packed.shape)}, g {tuple(g.shape)} "
                         f"and v {tuple(v.shape)} must share a shape")
    return torch.empty_like(packed), torch.empty_like(v)


def _madam_scalars(bc, fmt: LNSFormat, lr, beta, eps):
    # (1-beta), beta, eps and lr*gamma: Python doubles rounded to f32 as
    # JAX's weak types round them
    return (fmt.bits, fmt.gamma, float(bc), 1.0 - beta, beta, eps,
            lr * fmt.gamma)


def _madam_args(packed, g, v, w_out, v_out, bc, fmt, lr, beta, eps):
    return (packed.data_ptr(), _DT[packed.dtype], g.data_ptr(), _DT[g.dtype],
            v.data_ptr(), w_out.data_ptr(), v_out.data_ptr(), packed.numel(),
            *_madam_scalars(bc, fmt, lr, beta, eps))


def madam_step(packed: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
               bc: float, fmt: LNSFormat, *, lr: float, beta: float,
               eps: float):
    """K3 on the card: the fused update of a 2-D packed leaf (uint8 words
    at B<=8, int32 at B<=16; g f32 or bf16; v f32) -> new
    ``(words, v)``."""
    w_out, v_out = _madam_check(packed, g, v, fmt)
    MADAM_STEP(*_madam_args(packed, g, v, w_out, v_out, bc, fmt, lr, beta,
                            eps), _madam_blocks(packed.numel()),
               _stream(packed))
    return w_out, v_out


def madam_step_stats(packed: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     bc: float, fmt: LNSFormat, *, lr: float, beta: float,
                     eps: float, requant=None):
    """K4 on the card: K3 plus the stat vector (f64, width 8): one row of
    partial sums per block, then a fixed-order sum over the rows."""
    w_out, v_out = _madam_check(packed, g, v, fmt)
    blocks = _madam_blocks(packed.numel())
    partials = torch.empty((blocks, 8), dtype=torch.float64,
                           device=packed.device)
    ratio, dst_max = requant if requant is not None else (0, 0)
    MADAM_STEP_STATS(*_madam_args(packed, g, v, w_out, v_out, bc, fmt, lr,
                                  beta, eps), ratio, dst_max,
                     partials.data_ptr(), blocks, _stream(packed))
    return w_out, v_out, partials.sum(dim=0)


# K7: at most this many leaves a launch (lns_requant.cu `RequantTable`,
# passed by value); threads a block
K7_MAX_LEAVES = 16
_K7_THREADS = 256


def regrid_shift(src: LNSFormat, dst: LNSFormat):
    """``(up, s)``: the re-grid multiplies codes by 2**s (``up``) or
    divides them by 2**s rounding half up; s is clamped where a larger
    shift gives the same words (every code saturates, or rounds to 0)."""
    if dst.gamma >= src.gamma:
        return 1, min((dst.gamma // src.gamma).bit_length() - 1, 7)
    return 0, min((src.gamma // dst.gamma).bit_length() - 1, 8)


def requant_pack_many(leaves, src, dst):
    """K7 on the card: re-grid the packed uint8 words of up to
    :data:`K7_MAX_LEAVES` leaves (any rank each) from ``src`` to ``dst``
    bits in one launch -> a list of uint8 tensors of the leaves' shapes.
    ``src`` and ``dst`` are one format for all, or one a leaf (equal)."""
    leaves = list(leaves)
    if not 1 <= len(leaves) <= K7_MAX_LEAVES:
        raise ValueError(f"K7 takes 1..{K7_MAX_LEAVES} leaves a launch, got "
                         f"{len(leaves)}")
    for p in leaves:
        if p.device.type != "cuda":
            raise ValueError(f"packed: expected a CUDA tensor, got "
                             f"{p.device}")
        if p.dtype != torch.uint8:
            raise ValueError(f"packed: dtype {p.dtype} is not uint8")
        if not p.is_contiguous():
            raise ValueError("packed: must be contiguous")
    src = ref.shared_format(src, len(leaves), "src")
    dst = ref.shared_format(dst, len(leaves), "dst")
    _check_fmt(src)
    _check_fmt(dst)
    outs = []
    for p in leaves:
        n = p.numel()
        if p.data_ptr() % 16 == 0:
            outs.append(torch.empty_like(p))
            continue
        # a misaligned slice: its output takes the same 16-byte residue
        buf = torch.empty((n + 16,), dtype=torch.uint8, device=p.device)
        off = (p.data_ptr() - buf.data_ptr()) % 16
        outs.append(buf[off:off + n].view(p.shape))
    work = [(p, o) for p, o in zip(leaves, outs) if p.numel()]
    if not work:
        return outs
    arr = ctypes.c_longlong * len(work)
    up, s = regrid_shift(src, dst)
    REQUANT_PACK(arr(*(p.data_ptr() for p, _ in work)),
                 arr(*(o.data_ptr() for _, o in work)),
                 arr(*(p.numel() for p, _ in work)), len(work), src.bits,
                 dst.bits, up, s, _K7_THREADS, _stream(work[0][0]))
    return outs


def requant_pack(packed: torch.Tensor, src: LNSFormat,
                 dst: LNSFormat) -> torch.Tensor:
    """K7 on the card: re-grid one leaf of packed uint8 words of any rank
    from ``src`` to ``dst`` bits (same shape, uint8); the grouped kernel
    with one entry."""
    return requant_pack_many([packed], src, dst)[0]


_CODE_DT = {torch.uint8: 8, torch.int16: 16, torch.int32: 16}  # widest B


def madam_step_unpacked(code: torch.Tensor, sign: torch.Tensor,
                        g: torch.Tensor, v: torch.Tensor, bc: float,
                        fmt: LNSFormat, *, lr: float, beta: float,
                        eps: float):
    """K9 on the card: the update of a 2-D leaf kept as ``(code, sign)``
    (code uint8 at B<=8, int16 or int32 at B<=16, written back in its own
    dtype; sign int8 ±1; g f32 or bf16; v f32) -> new ``(code, v)``.
    The counterpart of ``repro.kernels.ops.madam_step``; the port's
    ``madam_step`` is the packed K3, as the JAX dispatch names it."""
    _check(code, "code", tuple(_CODE_DT), 2)
    if not 2 <= fmt.bits <= _CODE_DT[code.dtype]:
        raise ValueError(f"{code.dtype} codes take 2..{_CODE_DT[code.dtype]}"
                         f"-bit formats, got {fmt}")
    _check(sign, "sign", (torch.int8,), 2)
    _check(g, "g", _FLOATS, 2)
    _check(v, "v", (torch.float32,), 2)
    if not code.shape == sign.shape == g.shape == v.shape:
        raise ValueError(f"code {tuple(code.shape)}, sign "
                         f"{tuple(sign.shape)}, g {tuple(g.shape)} and v "
                         f"{tuple(v.shape)} must share a shape")
    c_out, v_out = torch.empty_like(code), torch.empty_like(v)
    MADAM_STEP_UNPACKED(code.data_ptr(), _DT[code.dtype], sign.data_ptr(),
                        g.data_ptr(), _DT[g.dtype], v.data_ptr(),
                        c_out.data_ptr(), v_out.data_ptr(), code.numel(),
                        *_madam_scalars(bc, fmt, lr, beta, eps),
                        _madam_blocks(code.numel()), _stream(code))
    return c_out, v_out


# K8's limits: byte words give m = ca + cb <= 254, so at most 256 LUT
# entries are read, and with frac_bits <= 16, gamma <= 4096 and block_k <=
# 4096 no int32 product or slice sum can overflow (a term is below 2**17)
_K8_LUT, _K8_MAX_GAMMA, _K8_MAX_BLOCK_K = 256, 4096, 4096
# K8's plan. Tiles: "wide" 128x64 outputs a block where they number at
# least _K8_FILL blocks (two an SM: a block keeps a 98 KB table), else
# "mid" 64x64, and "skinny" 4x256 at M <= _K8_SKINNY_M. Mid and skinny
# tiles split K in whole block_k slices: at least _K8_SPLIT_SLICES slices a
# split, at most _K8_MAX_SPLITS splits, at most 4 x _K8_FILL blocks (the
# workspace holds 3 int32 a split an output), each split's K under
# _K8_SPLIT_MAX_K (its sum of slice sums, < 2**17 a term, stays in int32),
# and at most _K8_MAX_TILES tiles (the kernel's arrival counters).
# _K8_REPL: copies of the term table a block keeps (32: no bank conflicts,
# 98 KB; 1: conflicts, 3 KB and a cheaper prologue). The constants come
# from `chip_smoke.py --k8-sweep` (PERF.md); the plan reads them when it is
# called.
_K8_FILL = 2 * 132
_K8_TILES = {"wide": (128, 64), "skinny": (4, 256), "mid": (64, 64)}
_K8_SKINNY_M = 8
_K8_MAX_SPLITS = {"wide": 1, "mid": 8, "skinny": 16}
_K8_SPLIT_SLICES = {"wide": 32, "mid": 32, "skinny": 1}
_K8_SPLIT_MAX_K = 16000
_K8_MAX_TILES = 65536
_K8_REPL = {"wide": 32, "mid": 32, "skinny": 1}


def _k8_tiles(cfg: str, M: int, N: int):
    bm, bn = _K8_TILES[cfg]
    return -(-M // bm), -(-N // bn)


def lns_matmul_plan(M: int, N: int, K: int, block_k: int = 16
                    ) -> Dict[str, int]:
    """K8's launch plan for ``(M,K) @ (K,N)``: the tile config, the table
    copies ``repl``, the grid (``grid_n`` x ``grid_m`` tiles x
    ``splits``) and the block_k ``slices`` each split takes."""
    if M <= _K8_SKINNY_M:
        cfg = "skinny"
    else:
        gm, gn = _k8_tiles("wide", M, N)
        cfg = "wide" if gm * gn >= _K8_FILL else "mid"
    grid_m, grid_n = _k8_tiles(cfg, M, N)
    tiles = grid_m * grid_n
    n_slices = -(-K // block_k)
    splits = 1
    if tiles <= _K8_MAX_TILES:
        splits = max(1, min(_K8_MAX_SPLITS[cfg],
                            n_slices // _K8_SPLIT_SLICES[cfg],
                            4 * _K8_FILL // tiles))
    per = -(-n_slices // splits) if n_slices else 0
    if per * block_k > _K8_SPLIT_MAX_K:
        per = n_slices
    splits = -(-n_slices // per) if per else 1        # no empty split
    return dict(cfg=cfg, repl=_K8_REPL[cfg], grid_n=grid_n, grid_m=grid_m,
                splits=splits, slices=per)


def lns_matmul_packed(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat, *,
                      frac_bits: int = 16, lut_entries: Optional[int] = None,
                      block_k: int = 16) -> torch.Tensor:
    """K8 on the card: the Fig.-6 integer datapath on packed uint8
    ``pa (M,K) @ pb (K,N)`` -> int32 ``(M,N)``, any M, N and K (no
    padding; a partial last K block is one block), through the tiles and
    split :func:`lns_matmul_plan` picks."""
    _check(pa, "pa", (torch.uint8,), 2)
    _check(pb, "pb", (torch.uint8,), 2)
    _check_fmt(fmt)
    M, K = pa.shape
    K2, N = pb.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(pa.shape)} @ "
                         f"{tuple(pb.shape)}")
    if fmt.gamma > _K8_MAX_GAMMA:
        raise ValueError(f"K8 takes gamma <= {_K8_MAX_GAMMA}, got {fmt}")
    if not 0 <= frac_bits <= 16:
        raise ValueError(f"K8 takes frac_bits in [0, 16], got {frac_bits}")
    if not 1 <= block_k <= _K8_MAX_BLOCK_K:
        raise ValueError(f"K8 takes block_k in [1, {_K8_MAX_BLOCK_K}], got "
                         f"{block_k}")
    plan = lns_matmul_plan(M, N, K, block_k)
    if plan["grid_m"] > 65535:
        raise ValueError(f"K8 takes at most 65535 row tiles, got {M} rows")
    # the numpy tables of core.conversion (bit-identical to the JAX
    # package's; they validate lut_entries), uploaded once per
    # format and device
    b = fmt.gamma.bit_length() - 1
    if lut_entries is None:
        b_l = -1
        lut = conversion.device_table(conversion.remainder_lut_neg_int,
                                      fmt.gamma, frac_bits, device=pa.device)
    else:
        b_l = b - (lut_entries.bit_length() - 1)
        lut = conversion.device_table(
            conversion.remainder_lut_neg_shifted_int, fmt.gamma, frac_bits,
            lut_entries, device=pa.device)
    lut = lut[:_K8_LUT]
    out = torch.empty((M, N), dtype=torch.int32, device=pa.device)
    ws = None
    if plan["splits"] > 1:       # (c, lo, hi) of every split's collector
        ws = torch.empty((plan["splits"], 3, M, N), dtype=torch.int32,
                         device=pa.device)
    aligned = (pa.data_ptr() % 4 == 0 and pb.data_ptr() % 4 == 0
               and K % 4 == 0 and N % 4 == 0 and block_k % 4 == 0)
    LNS_MATMUL_PACKED(pa.data_ptr(), pb.data_ptr(), lut.data_ptr(),
                      out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                      M, N, K, fmt.bits, b, b_l, block_k,
                      tuple(_K8_TILES).index(plan["cfg"]), plan["repl"],
                      plan["splits"], plan["slices"], int(aligned),
                      _stream(pa))
    return out
