"""Quantized GEMMs on LNS, forward (inference) only.

``qeinsum`` is the one entry every model projection goes through, as in
``repro.core.quantizer``:

* a packed 2-D :class:`LNSWeight` on a routable contraction goes to the
  routed GEMM: the activation is Q_log-encoded and packed
  (``dispatch.encode_pack``, K1) and multiplied against the weight's words
  (``dispatch.qmatmul``, K2) with the scales in the epilogue;
* anything else takes the fake-quant leg: Q_A and Q_W put both operands on
  the LNS grid, then a plain ``torch.einsum`` (the tied LM head goes here,
  as it does in the JAX package, where XLA runs that product).

Training (straight-through gradients, Q_E, Q_G) comes with the training
slice; nothing here builds an autograd graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.lns import (LNSFormat, LNSWeight, is_lns_weight,
                                  lns_quantize, lns_requant_packed)
from repro_torch.kernels import dispatch

__all__ = ["QuantConfig", "qeinsum", "quantize"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The forward quantizers Q_W and Q_A (``None`` disables one). Scale
    axes: ``None`` is per tensor, an int keeps resolution on that axis.
    The backward ones (Q_E, Q_G) and Q_U come with the training slice."""

    weight: Optional[LNSFormat] = None
    act: Optional[LNSFormat] = None
    weight_scale_axis: Optional[int] = -1
    act_scale_axis: Optional[int] = None

    @classmethod
    def lns_madam(cls, bits: int = 8, gamma: int = 8) -> "QuantConfig":
        """The paper's setting: B=8, γ=8 on weights and activations."""
        fmt = LNSFormat(bits=bits, gamma=gamma)
        return cls(weight=fmt, act=fmt)

    @property
    def is_quantized(self) -> bool:
        return self.weight is not None or self.act is not None


def quantize(x: torch.Tensor, fmt: Optional[LNSFormat],
             scale_axis: Optional[int] = None) -> torch.Tensor:
    """Q_log onto ``fmt``'s grid (identity for ``fmt=None``)."""
    return x if fmt is None else lns_quantize(x, fmt, scale_axis=scale_axis)


def _route_plan(eq: str) -> bool:
    """True for a plain 2-D contraction ``...k,kn->...n``."""
    try:
        lhs, out = eq.replace(" ", "").split("->")
        xs, ws = lhs.split(",")
    except ValueError:
        return False
    return (len(ws) == 2 and xs[-1] == ws[0] and out == xs[:-1] + ws[1]
            and len(set(xs)) == len(xs) and ws[1] not in xs)


def _routable(eq: str, w: LNSWeight, cfg: Optional[QuantConfig]) -> bool:
    """Can this GEMM take the packed kernel path? Both operands on one
    LNS grid, a per-tensor activation scale, a 2-D weight whose scale is
    constant along the contraction axis."""
    if cfg is None or cfg.weight is None or cfg.act is None:
        return False
    if cfg.weight != cfg.act or cfg.act_scale_axis is not None:
        return False
    if w.ndim != 2:
        return False
    s = w.scale
    if s.dim() not in (0, 2) or (s.dim() == 2 and s.shape[0] != 1):
        return False
    return _route_plan(eq)


def _forward_packed(w: LNSWeight, ffmt: LNSFormat) -> torch.Tensor:
    """The weight's words on the forward grid: unchanged when the storage
    format is the forward format, else an integer re-grid."""
    if (w.fmt.bits, w.fmt.gamma) == (ffmt.bits, ffmt.gamma):
        return w.packed
    return lns_requant_packed(w.packed, w.fmt, ffmt)


def _routed_impl(fmt: LNSFormat, x: torch.Tensor, pw: torch.Tensor,
                 wscale: torch.Tensor) -> torch.Tensor:
    """y = decode(Q_A(x)) @ decode(pw) * s_x * s_w through K1 and K2."""
    K = x.shape[-1]
    xm = x.reshape(-1, K).contiguous()
    px, sx = dispatch.encode_pack(xm, fmt, scale_axis=None)
    sw = wscale.reshape(1, -1).to(torch.float32).expand(1, pw.shape[1])
    y = dispatch.qmatmul(px, pw, fmt, scale_a=sx, scale_b=sw.contiguous(),
                         compute_dtype=x.dtype)
    return y.reshape(x.shape[:-1] + (pw.shape[1],)).to(x.dtype)


def qeinsum(eq: str, x: torch.Tensor, w,
            cfg: Optional[QuantConfig]) -> torch.Tensor:
    """``einsum(eq, Q_A(x), Q_W(w))``; packed 2-D weights route through
    the kernels, dense ones take the fake-quant leg."""
    if is_lns_weight(w):
        if _routable(eq, w, cfg):
            return _routed_impl(cfg.weight, x, _forward_packed(w, cfg.weight),
                                w.scale)
        w = w.decode(x.dtype)
    if cfg is None or not cfg.is_quantized:
        return torch.einsum(eq, x, w)
    xq = quantize(x, cfg.act, cfg.act_scale_axis)
    wq = quantize(w, cfg.weight, cfg.weight_scale_axis)
    return torch.einsum(eq, xq, wq)
