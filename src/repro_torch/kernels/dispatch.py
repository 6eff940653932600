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

from repro_torch.core.lns import LNSFormat
from repro_torch.kernels import ops, ref
from repro_torch.kernels.madam_stats import madam_stats_dict, requant_spec

__all__ = ["route", "encode_pack", "qmatmul", "paged_attend", "fused_sample",
           "madam_step"]


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
