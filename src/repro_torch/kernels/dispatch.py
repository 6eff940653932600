"""One dispatch point for the kernels, chosen by tensor device.

* A CPU tensor goes to the plain PyTorch version (``kernels.ref``).
* A CUDA tensor launches the hand-written kernel (``kernels.ops``), or the
  wrapper raises. There is no fallback from a CUDA tensor to the plain
  version, and no setting that reroutes one.

Any other device raises. The JAX package's backend precedence chain
(``configure()``, per-call argument, env var, platform) has no counterpart
here: the caller picks the device, and the device picks the path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lns import LNSFormat, compute_scale, lns_encode, lns_pack
from repro_torch.kernels import ops, ref
from repro_torch.kernels.madam_stats import madam_stats_dict, requant_spec

__all__ = ["route", "encode_pack", "qmatmul", "paged_attend", "fused_sample",
           "madam_step", "madam_step_unpacked", "requant_pack",
           "lns_matmul_packed", "lns_matmul"]


def route(t) -> str:
    """``"plain"`` for a CPU tensor, ``"kernel"`` for a CUDA one."""
    kind = t.device.type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no kernel path for device {t.device}")


def encode_pack(x: torch.Tensor, fmt: LNSFormat,
                scale_axis: Optional[int] = None):
    """K1: Q_log-encode a 2-D tensor -> ``(packed (R,C), scale (R,1))``."""
    impl = ops.encode_pack if route(x) == "kernel" else ref.encode_pack
    return impl(x, fmt, scale_axis)


def qmatmul(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat,
            scale_a: Optional[torch.Tensor] = None,
            scale_b: Optional[torch.Tensor] = None, *,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """K2: packed ``pa (M,K) @ pb (K,N)`` -> f32, row/column scales."""
    impl = ops.qmatmul if route(pa) == "kernel" else ref.qmatmul
    return impl(pa, pb, fmt, scale_a, scale_b, compute_dtype=compute_dtype)


def paged_attend(q, kp, vp, k_scale, v_scale, block_table, lengths, *,
                 fmt: Optional[LNSFormat] = None,
                 softcap: Optional[float] = None,
                 sm_scale: float) -> torch.Tensor:
    """K5: attend ``q (B,S,h,hd)`` over a paged pool -> f32."""
    impl = ops.paged_attend if route(q) == "kernel" else ref.paged_attend
    return impl(q, kp, vp, k_scale, v_scale, block_table, lengths, fmt=fmt,
                softcap=softcap, sm_scale=sm_scale)


def fused_sample(logits: torch.Tensor, gumbel: Optional[torch.Tensor],
                 temp: Optional[torch.Tensor]) -> torch.Tensor:
    """K6: ``logits (B,V)`` -> ``(B,)`` int32 tokens."""
    impl = ops.fused_sample if route(logits) == "kernel" else ref.fused_sample
    return impl(logits, gumbel, temp)


def requant_pack(packed: torch.Tensor, src: LNSFormat,
                 dst: LNSFormat) -> torch.Tensor:
    """K7: re-grid packed words of any rank from ``src`` to ``dst`` bits
    (the self-speculative draft view; integer-only, scales untouched)."""
    impl = ops.requant_pack if route(packed) == "kernel" else ref.requant_pack
    return impl(packed, src, dst)


def madam_step(packed: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
               count: int, fmt: LNSFormat, *, lr: float, beta: float = 0.999,
               eps: float = 1e-30, with_stats: bool = False,
               requant_fmt: Optional[LNSFormat] = None):
    """K3 (K4 with ``with_stats``): the fused Algorithm-1 step on a packed
    leaf of rank >= 2, folded to ``(-1, last)``. ``count`` is the
    post-increment step (a host int, so reading it costs no device sync).
    Returns ``(new_packed, new_v)``, plus the dict of
    ``madam_stats.MADAM_STAT_KEYS`` with ``with_stats``."""
    kernel = route(packed) == "kernel"
    shape = packed.shape
    if len(shape) < 2:
        raise ValueError(f"madam_step needs a >=2-D leaf, got {tuple(shape)}")
    p2 = packed.reshape(-1, shape[-1])
    g2 = g.reshape(p2.shape)
    v2 = v.reshape(p2.shape)
    bc = ref.bias_correction(beta, count)
    kw = dict(lr=lr, beta=beta, eps=eps)
    if not with_stats:
        impl = ops.madam_step if kernel else ref.madam_step
        np_, nv = impl(p2, g2, v2, bc, fmt, **kw)
        return np_.reshape(shape), nv.reshape(shape)
    impl = ops.madam_step_stats if kernel else ref.madam_step_stats
    np_, nv, vec = impl(p2, g2, v2, bc, fmt,
                        requant=requant_spec(fmt, requant_fmt), **kw)
    return (np_.reshape(shape), nv.reshape(shape),
            madam_stats_dict(vec, p2.numel(), fmt))


def madam_step_unpacked(code: torch.Tensor, sign: torch.Tensor,
                        g: torch.Tensor, v: torch.Tensor, count: int,
                        fmt: LNSFormat, *, lr: float, beta: float = 0.999,
                        eps: float = 1e-30):
    """K9: the Algorithm-1 step on a 2-D leaf kept as ``(code, sign)``
    (the counterpart of ``repro.kernels.ops.madam_step``); ``count`` is
    the post-increment step. Returns ``(new_code, new_v)``."""
    impl = (ops.madam_step_unpacked if route(code) == "kernel"
            else ref.madam_step_unpacked)
    return impl(code, sign, g, v, ref.bias_correction(beta, count), fmt,
                lr=lr, beta=beta, eps=eps)


def lns_matmul_packed(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat, *,
                      frac_bits: int = 16, lut_entries: Optional[int] = None,
                      block_k: int = 16) -> torch.Tensor:
    """K8: the Fig.-6 integer datapath on packed ``pa (M,K) @ pb (K,N)``
    -> int32 partial sums in ``frac_bits`` fixed point."""
    impl = (ops.lns_matmul_packed if route(pa) == "kernel"
            else ref.lns_matmul_packed)
    return impl(pa, pb, fmt, frac_bits=frac_bits, lut_entries=lut_entries,
                block_k=block_k)


def lns_matmul(a: torch.Tensor, b: torch.Tensor, fmt: LNSFormat, *,
               frac_bits: int = 16, lut_entries: Optional[int] = None,
               block_k: int = 16) -> torch.Tensor:
    """The datapath matmul on real 2-D inputs, as
    ``repro.kernels.ops.lns_matmul``: per-tensor pow2 scales, Q_log encode
    and pack of both operands, K8, then ``out · s_a·s_b / 2**frac_bits``
    in f32 (exact: the scales are powers of two and |out| < 2**24).

    K is padded to a multiple of ``block_k`` with ``max_code`` words
    (positive, smallest magnitude), exactly as the JAX function pads it.
    K8 itself needs no padding, but a pad pair is not always zero: at
    B=8, γ<=8 its product exponent 254 shifts it out (q = 31), while at
    B=4, γ=4 each pad pair adds 5792 (2**-3.5 in Q.16) to the last block.
    Padding the same way keeps the result equal to JAX's for every
    format."""
    sa, sb = compute_scale(a), compute_scale(b)
    pa = lns_pack(*lns_encode(a, fmt, sa), fmt)
    pb = lns_pack(*lns_encode(b, fmt, sb), fmt)
    pad = -a.shape[1] % block_k
    if pad:
        pa = F.pad(pa, (0, pad), value=fmt.max_code)
        pb = F.pad(pb, (0, 0, 0, pad), value=fmt.max_code)
    out = lns_matmul_packed(pa.contiguous(), pb.contiguous(), fmt,
                            frac_bits=frac_bits, lut_entries=lut_entries,
                            block_k=block_k)
    return out.to(torch.float32) * (sa * sb) / (1 << frac_bits)
