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

import torch

from repro_torch.core.lns import LNSFormat
from repro_torch.kernels import _build, ref

__all__ = ["Kernel", "KERNELS", "ENCODE_PACK", "QMATMUL", "PAGED_ATTEND",
           "FUSED_SAMPLE", "launch_counts", "reset_launch_counts",
           "encode_pack", "qmatmul", "paged_attend", "fused_sample"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 3}


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
                     [_P, _I, _P, _P, _LL, _LL, _I, _I, _P])
QMATMUL = Kernel("qmatmul", "repro_qmatmul",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
PAGED_ATTEND = Kernel("paged_attend", "repro_paged_attend",
                      [_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P])
FUSED_SAMPLE = Kernel("fused_sample", "repro_fused_sample",
                      [_P, _P, _P, _P, _I, _I, _P])
KERNELS: Dict[str, Kernel] = {k.name: k for k in
                              (ENCODE_PACK, QMATMUL, PAGED_ATTEND,
                               FUSED_SAMPLE)}


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


def encode_pack(x: torch.Tensor, fmt: LNSFormat,
                scale_axis: Optional[int] = None):
    """K1 on the card -> ``(packed uint8 (R,C), scale (R,1) f32)``."""
    _check(x, "x", _FLOATS, 2)
    _check_fmt(fmt)
    srow = ref.row_scale(x, scale_axis)       # torch reduction, as on TPU
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    ENCODE_PACK(x.data_ptr(), _DT[x.dtype], srow.data_ptr(), out.data_ptr(),
                x.shape[0], x.shape[1], fmt.bits, fmt.gamma, _stream(x))
    return out, srow


def _scale_ptr(s: Optional[torch.Tensor], shape, name: str) -> int:
    if s is None:
        return 0
    _check(s, name, (torch.float32,), 2)
    if tuple(s.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(s.shape)}")
    return s.data_ptr()


def qmatmul(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat,
            scale_a: Optional[torch.Tensor] = None,
            scale_b: Optional[torch.Tensor] = None, *,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """K2 on the card: packed ``(M,K) @ (K,N)`` -> f32 with scales."""
    _check(pa, "pa", (torch.uint8,), 2)
    _check(pb, "pb", (torch.uint8,), 2)
    _check_fmt(fmt)
    if compute_dtype not in _FLOATS:
        raise ValueError(f"compute_dtype {compute_dtype} not in {_FLOATS}")
    M, K = pa.shape
    K2, N = pb.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(pa.shape)} @ "
                         f"{tuple(pb.shape)}")
    pa_s = _scale_ptr(scale_a, (M, 1), "scale_a")
    pb_s = _scale_ptr(scale_b, (1, N), "scale_b")
    out = torch.empty((M, N), dtype=torch.float32, device=pa.device)
    QMATMUL(pa.data_ptr(), pb.data_ptr(), pa_s, pb_s, out.data_ptr(), M, N, K,
            fmt.bits, fmt.gamma, _DT[compute_dtype], _stream(pa))
    return out


def paged_attend(q, kp, vp, k_scale, v_scale, block_table, lengths, *,
                 fmt: Optional[LNSFormat] = None,
                 softcap: Optional[float] = None,
                 sm_scale: float) -> torch.Tensor:
    """K5 on the card: paged GQA attention -> f32 ``(B,S,h,hd)``."""
    _check(q, "q", _FLOATS, 4)
    B, S, H, hd = q.shape
    pool_dt = (torch.uint8,) if fmt is not None else _FLOATS
    _check(kp, "kp", pool_dt, 4)
    _check(vp, "vp", pool_dt, 4)
    if vp.shape != kp.shape or kp.dtype != vp.dtype:
        raise ValueError("kp and vp must share shape and dtype")
    _, page, KV, hd2 = kp.shape
    if hd2 != hd or H % KV or hd not in (32, 64, 128):
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(kp.shape)}: "
                         f"need equal head_dim in (32, 64, 128) and KV | H")
    if 2 * page * hd * 4 > 48 * 1024:
        raise ValueError(f"page {page} x head_dim {hd} exceeds the kernel's "
                         f"48 KB page staging")
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
                 _stream(q))
    return out


def fused_sample(logits: torch.Tensor, gumbel: Optional[torch.Tensor],
                 temp: Optional[torch.Tensor]) -> torch.Tensor:
    """K6 on the card: ``(B, V)`` f32 logits -> ``(B,)`` int32 tokens."""
    _check(logits, "logits", (torch.float32,), 2)
    B, V = logits.shape
    g_p = t_p = 0
    if gumbel is not None:
        _check(gumbel, "gumbel", (torch.float32,), 2)
        _check(temp, "temp", (torch.float32,), 1)
        if tuple(gumbel.shape) != (B, V) or temp.shape[0] != B:
            raise ValueError("gumbel must be (B, V) and temp (B,)")
        g_p, t_p = gumbel.data_ptr(), temp.data_ptr()
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    FUSED_SAMPLE(logits.data_ptr(), g_p, t_p, out.data_ptr(), B, V,
                 _stream(logits))
    return out
