"""Quantized GEMMs on LNS, forward and backward (paper §3, Fig. 3).

``qeinsum`` is the one entry every model projection goes through, as in
``repro.core.quantizer``:

* a packed 2-D :class:`LNSWeight` on a routable contraction goes to the
  routed GEMM: the activation is Q_log-encoded and packed
  (``dispatch.encode_pack``, K1) and multiplied against the weight's words
  (``dispatch.qmatmul``, K2) with the scales in the epilogue;
* anything else takes the fake-quant leg: Q_A and Q_W put both operands on
  their grid (LNS, or a miniature float for the paper's FP8 baseline)
  with straight-through gradients, then a plain ``torch.einsum`` (the
  tied LM head goes here, as it does in the JAX package, where XLA runs
  that product);
* with ``QuantConfig.approx_lut`` set, no GEMM routes: packed weights
  decode per leaf and every GEMM simulates the hybrid conversion
  approximation (``core.quant_training.approx_qeinsum``, paper Table 10).

Training adds Q_E on each GEMM output's gradient (:func:`backward_quantize`)
and Q_G on the final weight gradients (:func:`quantize_grads`). The routed
GEMM's gradient is :class:`_RoutedMatmul`, which saves the packed
activation (1 byte per element) rather than a dense one and returns dW into
the weight's ``delta`` carrier. Without a carrier (serving) the routed GEMM
and the quantizers build no autograd node at all.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.lns import (LNSFormat, LNSWeight, is_lns_weight,
                                  lns_decode_packed, lns_quantize,
                                  lns_requant_packed)
from repro_torch.kernels import dispatch
from repro_torch.numerics.fp import FPFormat, fp_quantize

__all__ = ["Format", "QuantConfig", "qeinsum", "quantize", "ste_quantize",
           "backward_quantize", "cot_boundary", "quantize_grads"]

Format = Union[LNSFormat, FPFormat]


def _apply_format(x: torch.Tensor, fmt: Format,
                  scale_axis: Optional[int]) -> torch.Tensor:
    if isinstance(fmt, LNSFormat):
        return lns_quantize(x, fmt, scale_axis=scale_axis)
    return fp_quantize(x, fmt, scale_axis=scale_axis)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Formats of the four quantizers (``None`` disables one): Q_W
    (weights) and Q_A (activations) before each GEMM, Q_E on each GEMM
    output's gradient, Q_G on the weight gradients, and Q_U, the update
    store the optimizer keeps. Scale axes: ``None`` is per tensor, an int
    keeps resolution on that axis."""

    weight: Optional[Format] = None
    act: Optional[Format] = None
    err: Optional[Format] = None
    grad: Optional[Format] = None
    update: Optional[Format] = None
    weight_scale_axis: Optional[int] = -1
    act_scale_axis: Optional[int] = None
    err_scale_axis: Optional[int] = None
    grad_scale_axis: Optional[int] = None
    # the hybrid conversion-approximation simulation (paper App. B, Table
    # 10): the number of LUT entries; None is exact accumulation
    approx_lut: Optional[int] = None

    @classmethod
    def lns_madam(cls, bits: int = 8, gamma: int = 8, update_bits: int = 16,
                  approx_lut: Optional[int] = None) -> "QuantConfig":
        """The paper's setting: B=8, γ=8 everywhere; Q_U at
        ``update_bits`` with γ widened to keep the range (§6.1.1)."""
        fmt = LNSFormat(bits=bits, gamma=gamma)
        return cls(weight=fmt, act=fmt, err=fmt, grad=fmt,
                   update=fmt.with_bits(update_bits), approx_lut=approx_lut)

    @classmethod
    def fp8(cls) -> "QuantConfig":
        """The paper's FP8 baseline: e4m3 for Q_W, Q_A, Q_E and Q_G;
        Q_U names FP16 (e5m10), which the train step does not read (as
        in the JAX package, the update store stays Madam's)."""
        fmt = FPFormat(exp_bits=4, man_bits=3)
        return cls(weight=fmt, act=fmt, err=fmt, grad=fmt,
                   update=FPFormat(exp_bits=5, man_bits=10))

    @classmethod
    def full_precision(cls) -> "QuantConfig":
        return cls()

    @property
    def is_quantized(self) -> bool:
        return any(f is not None for f in (self.weight, self.act, self.err,
                                           self.grad))


def quantize(x: torch.Tensor, fmt: Optional[Format],
             scale_axis: Optional[int] = None) -> torch.Tensor:
    """Onto ``fmt``'s grid: Q_log for an LNS format, the miniature-float
    grid for an ``FPFormat`` (identity for ``fmt=None``)."""
    return x if fmt is None else _apply_format(x, fmt, scale_axis)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The value of ``q`` with the gradient of the identity in ``x``.

    With a gradient to carry this is ``x + (q - x).detach()``, the JAX
    expression and its rounding; without one it is ``q``, which equals
    it except where the encode clamps a value far below the grid."""
    if not _needs_grad(x):
        return q
    return x + (q - x).detach()


def ste_quantize(x: torch.Tensor, fmt: Optional[Format],
                 scale_axis: Optional[int] = None) -> torch.Tensor:
    """Forward: onto the grid. Backward: identity (straight through)."""
    if fmt is None:
        return x
    return ste(x, quantize(x, fmt, scale_axis))


class _BackwardQuantize(torch.autograd.Function):
    """Identity forward; the gradient is put on ``fmt``'s grid (Q_E) and
    cast to ``cot_dtype``."""

    @staticmethod
    def forward(ctx, x, fmt, scale_axis, cot_dtype):
        ctx.fmt, ctx.scale_axis, ctx.cot_dtype = fmt, scale_axis, cot_dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.fmt is not None:
            g = _apply_format(g, ctx.fmt, ctx.scale_axis)
        if ctx.cot_dtype is not None:
            g = g.to(ctx.cot_dtype)
        return g, None, None, None


def backward_quantize(x: torch.Tensor, fmt: Optional[Format],
                      scale_axis: Optional[int] = None,
                      cot_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Forward identity; backward quantizes the gradient (the paper's
    Q_E) and stores it in ``cot_dtype``. No node without a gradient."""
    if not _needs_grad(x):
        return x
    return _BackwardQuantize.apply(x, fmt, scale_axis, cot_dtype)


def cot_boundary(x: torch.Tensor) -> torch.Tensor:
    """Forward identity; the gradient is cast to ``x.dtype``. The port's
    layers need no such boundary (autograd already returns a gradient in
    its input's dtype); this is the JAX function's counterpart for code
    that moves a gradient across dtypes itself."""
    return backward_quantize(x, None, None, x.dtype)


def quantize_grads(grads, cfg: Optional[QuantConfig]):
    """Q_G on a gradient tree (nested dicts of tensors), per-tensor
    scales unless ``cfg.grad_scale_axis`` says otherwise."""
    if cfg is None or cfg.grad is None:
        return grads
    if isinstance(grads, dict):
        return {k: quantize_grads(v, cfg) for k, v in grads.items()}
    return _apply_format(grads, cfg.grad, cfg.grad_scale_axis)


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
    LNS grid (a miniature-float format never routes), a per-tensor
    activation scale, a 2-D weight whose scale is constant along the
    contraction axis, and no conversion-approximation simulation."""
    if cfg is None or cfg.approx_lut is not None:
        return False
    if not (isinstance(cfg.weight, LNSFormat)
            and isinstance(cfg.act, LNSFormat)):
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
                 wscale: torch.Tensor):
    """y = decode(Q_A(x)) @ decode(pw) * s_x * s_w through K1 and K2.
    Returns ``(y, px, sx)``: the packed activation and its scale are the
    backward's residuals."""
    K = x.shape[-1]
    xm = x.reshape(-1, K).contiguous()
    px, sx = dispatch.encode_pack(xm, fmt, scale_axis=None)
    sw = wscale.reshape(1, -1).to(torch.float32).expand(1, pw.shape[1])
    y = dispatch.qmatmul(px, pw, fmt, scale_a=sx, scale_b=sw.contiguous(),
                         compute_dtype=x.dtype, out_dtype=x.dtype)
    return y.reshape(x.shape[:-1] + (pw.shape[1],)), px, sx


class _RoutedMatmul(torch.autograd.Function):
    """The routed GEMM with straight-through gradients
    (``_routed_fwd``/``_routed_bwd`` of the JAX package). ``delta`` is
    ignored by the primal; the backward returns dW into it."""

    @staticmethod
    def forward(ctx, fmt, x, delta, pw, wscale):
        y, px, sx = _routed_impl(fmt, x, pw, wscale)
        ctx.fmt = fmt
        ctx.x_dtype, ctx.d_dtype = x.dtype, delta.dtype
        ctx.x_shape = x.shape
        ctx.save_for_backward(px, sx, pw, wscale)
        return y

    @staticmethod
    def backward(ctx, dy):
        px, sx, pw, wscale = ctx.saved_tensors
        fmt, xdt = ctx.fmt, ctx.x_dtype
        dym = dy.reshape(-1, dy.shape[-1]).to(xdt)
        # STE: dx = dy @ Wq^T (Q_A taken as identity); dW = Q_A(x)^T @ dy
        wq = (lns_decode_packed(pw, fmt, torch.float32)
              * wscale.reshape(1, -1)).to(xdt)
        xq = (lns_decode_packed(px, fmt, torch.float32) * sx).to(xdt)
        dx = (dym @ wq.T).reshape(ctx.x_shape).to(xdt)
        ddelta = (xq.T @ dym).to(ctx.d_dtype)
        return None, dx, ddelta, None, None


def qeinsum(eq: str, x: torch.Tensor, w,
            cfg: Optional[QuantConfig]) -> torch.Tensor:
    """``einsum(eq, Q_A(x), Q_W(w))`` with Q_E on the output's gradient;
    packed 2-D weights route through the kernels, dense ones take the
    fake-quant leg. A packed weight without a ``delta`` (serving) calls
    the kernels with no autograd machinery, as the JAX package does."""
    if is_lns_weight(w):
        if _routable(eq, w, cfg):
            pw = _forward_packed(w, cfg.weight)
            if w.delta is None:
                y = _routed_impl(cfg.weight, x, pw, w.scale)[0]
            else:
                y = _RoutedMatmul.apply(cfg.weight, x, w.delta, pw, w.scale)
            return backward_quantize(y, cfg.err, cfg.err_scale_axis, x.dtype)
        w = w.decode(x.dtype)      # per-leaf fallback; delta carries grads
    if cfg is None or not cfg.is_quantized:
        return backward_quantize(torch.einsum(eq, x, w), None, None, x.dtype)
    if cfg.approx_lut is not None and cfg.weight is not None:
        from repro_torch.core.quant_training import approx_qeinsum
        y = approx_qeinsum(eq, x, w, cfg)
    else:
        xq = ste_quantize(x, cfg.act, cfg.act_scale_axis)
        wq = ste_quantize(w, cfg.weight, cfg.weight_scale_axis)
        y = torch.einsum(eq, xq, wq)
    return backward_quantize(y, cfg.err, cfg.err_scale_axis, x.dtype)
