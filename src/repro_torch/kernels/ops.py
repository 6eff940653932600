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

from repro_torch.core import conversion
from repro_torch.core.lns import LNSFormat
from repro_torch.kernels import _build, ref

__all__ = ["Kernel", "KERNELS", "ENCODE_PACK", "QMATMUL", "PAGED_ATTEND",
           "FUSED_SAMPLE", "MADAM_STEP", "MADAM_STEP_STATS", "REQUANT_PACK",
           "LNS_MATMUL_PACKED", "MADAM_STEP_UNPACKED", "launch_counts",
           "reset_launch_counts", "encode_pack", "qmatmul", "paged_attend",
           "fused_sample", "madam_step", "madam_step_stats", "requant_pack",
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
                     [_P, _I, _P, _P, _LL, _LL, _I, _I, _P])
QMATMUL = Kernel("qmatmul", "repro_qmatmul",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
PAGED_ATTEND = Kernel("paged_attend", "repro_paged_attend",
                      [_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P])
FUSED_SAMPLE = Kernel("fused_sample", "repro_fused_sample",
                      [_P, _P, _P, _P, _I, _I, _P])
_MADAM_ARGS = [_P, _I, _P, _I, _P, _P, _P, _LL, _I, _I, _F, _F, _F, _F, _F]
MADAM_STEP = Kernel("madam_step", "repro_madam_step", _MADAM_ARGS + [_I, _P])
MADAM_STEP_STATS = Kernel("madam_step_stats", "repro_madam_step_stats",
                          _MADAM_ARGS + [_I, _I, _P, _I, _P])
REQUANT_PACK = Kernel("requant_pack", "repro_requant_pack",
                      [_P, _P, _LL, _I, _I, _I, _I, _P])
LNS_MATMUL_PACKED = Kernel("lns_matmul_packed", "repro_lns_matmul",
                           [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P])
MADAM_STEP_UNPACKED = Kernel("madam_step_unpacked",
                             "repro_madam_step_unpacked",
                             [_P, _I, _P, _P, _I, _P, _P, _P, _LL, _I, _I,
                              _F, _F, _F, _F, _F, _I, _P])
KERNELS: Dict[str, Kernel] = {k.name: k for k in
                              (ENCODE_PACK, QMATMUL, PAGED_ATTEND,
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
    if hd2 != hd or H % KV or hd not in (16, 32, 64, 128):
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(kp.shape)}: "
                         f"need equal head_dim in (16, 32, 64, 128) and "
                         f"KV | H")
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


def requant_pack(packed: torch.Tensor, src: LNSFormat,
                 dst: LNSFormat) -> torch.Tensor:
    """K7 on the card: re-grid packed uint8 words of any rank from ``src``
    to ``dst`` bits (same shape, uint8)."""
    if packed.device.type != "cuda":
        raise ValueError(f"packed: expected a CUDA tensor, got "
                         f"{packed.device}")
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed: dtype {packed.dtype} is not uint8")
    if not packed.is_contiguous():
        raise ValueError("packed: must be contiguous")
    _check_fmt(src)
    _check_fmt(dst)
    if dst.gamma >= src.gamma:
        mul, div = dst.gamma // src.gamma, 0
    else:
        mul, div = 0, src.gamma // dst.gamma
    out = torch.empty_like(packed)
    REQUANT_PACK(packed.data_ptr(), out.data_ptr(), packed.numel(), src.bits,
                 dst.bits, mul, div, _stream(packed))
    return out


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


# K8's limits: the LUT sits in 256 ints of shared memory (byte words give
# remainders below 255 whatever gamma is), and with frac_bits <= 16,
# gamma <= 4096 and block_k <= 4096 no int32 product or block sum can
# overflow (a term is below 2**17)
_K8_LUT, _K8_MAX_GAMMA, _K8_MAX_BLOCK_K = 256, 4096, 4096


def lns_matmul_packed(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat, *,
                      frac_bits: int = 16, lut_entries: Optional[int] = None,
                      block_k: int = 16) -> torch.Tensor:
    """K8 on the card: the Fig.-6 integer datapath on packed uint8
    ``pa (M,K) @ pb (K,N)`` -> int32 ``(M,N)``, any M, N and K (no
    padding; a partial last K block is one block)."""
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
    if -(-M // 64) > 65535:
        raise ValueError(f"K8 takes at most {65535 * 64} rows, got {M}")
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
    LNS_MATMUL_PACKED(pa.data_ptr(), pb.data_ptr(), lut.data_ptr(),
                      lut.numel(), out.data_ptr(), M, N, K, fmt.bits, b, b_l,
                      block_k, _stream(pa))
    return out
