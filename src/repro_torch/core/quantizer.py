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
and Q_G on the final weight gradients (:func:`quantize_grads`).

Under a data-parallel mesh each rank holds its rows of the global batch,
and every per-tensor scale of an activation (Q_A) or an error (Q_E) is
the global batch's: the rank's own scale max-reduced over the group the
active rules split ``"batch"`` over (:func:`global_stat`;
``sharding.batch_group``), then handed to K1 (``encode_pack(scale=)``) or
to the fake-quant encode. ``pow2_scale`` is monotone, so the max of the
ranks' scales is the scale of the global absmax, exactly. Where one
tensor feeds several GEMMs (q/k/v, up/gate) the caller reduces its scale
once and passes it to each (``qeinsum(x_stat=)``). Q_G is taken on the
summed gradient. The serving rules replicate the batch, so serving
reduces nothing here.

Under tensor-parallel training (the weights on the serving rules, a
column-parallel GEMM holding this rank's columns) the output of such a
GEMM is split over the model group as well: its Q_E scale is the whole
tensor's, max-reduced over the batch and model groups jointly
(``qeinsum(out_axis=)``), and Q_G on a column-sharded leaf's gradient
max-reduces over that leaf's shard group (``quantize_grads(groups=)``).
Under JAX's training placement (``sharding.train_rules``) the input of a
row-parallel GEMM (``wo``, ``down`` holding this rank's rows) is split
by columns, and its Q_A scale is max-reduced over the batch and model
groups jointly (``act_stat(split=)``) before K1 encodes the rank's
columns with it.
Q_W's per-output-channel scales on a column-sharded leaf are the rank's
own columns, so they need no reduce; a replicated leaf reduces nothing
over model. The routed
GEMM's gradient is :class:`_RoutedMatmul`, which saves the packed
activation (1 byte per element) rather than a dense one and returns dW into
the weight's ``delta`` carrier. Without a carrier (serving) the routed GEMM
and the quantizers build no autograd node at all.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.lns import (LNSFormat, LNSWeight, compute_scale,
                                  is_lns_weight, lns_decode_packed,
                                  lns_quantize, lns_requant_packed)
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import batch_group, joint_group
from repro_torch.kernels import dispatch
from repro_torch.numerics.fp import FPFormat, fp_absmax, fp_quantize

__all__ = ["Format", "QuantConfig", "qeinsum", "quantize", "ste_quantize",
           "ste_quantize_sharded", "backward_quantize", "cot_boundary",
           "quantize_grads", "global_stat", "act_stat"]

Format = Union[LNSFormat, FPFormat]


def _stat(x: torch.Tensor, fmt: Format,
          scale_axis: Optional[int]) -> torch.Tensor:
    """What ``fmt``'s scale is made of: the pow2 scale of an LNS format,
    the absmax of a miniature float (its scale is monotone in it)."""
    if isinstance(fmt, LNSFormat):
        return compute_scale(x, axis=scale_axis)
    return fp_absmax(x, scale_axis)


def _apply_format(x: torch.Tensor, fmt: Format, scale_axis: Optional[int],
                  stat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Onto ``fmt``'s grid under ``x``'s own scale, or the one ``stat``
    (:func:`_stat` of the whole tensor) gives."""
    if isinstance(fmt, LNSFormat):
        return lns_quantize(x, fmt, scale_axis=scale_axis, scale=stat)
    return fp_quantize(x, fmt, scale_axis=scale_axis, absmax=stat)


def global_stat(x: torch.Tensor, fmt: Optional[Format],
                scale_axis: Optional[int] = None,
                group=None) -> Optional[torch.Tensor]:
    """The scale statistic of the whole tensor of which ``x`` holds this
    rank's rows (dim 0 split over ``group``): the rank's own, max-reduced
    over the group. None without a format or a group, and where the
    scale keeps dim 0 (each row's scale is then the rank's own)."""
    if fmt is None or group is None:
        return None
    if scale_axis is not None and scale_axis % x.dim() == 0:
        return None
    st = _stat(x, fmt, scale_axis).detach()    # a scale takes no gradient
    return collectives.max_reduce(st.reshape(-1), group).reshape(st.shape)


def act_stat(x: torch.Tensor, cfg: Optional["QuantConfig"],
             split: Optional[str] = None) -> Optional[torch.Tensor]:
    """Q_A's global statistic of ``x`` under the active mesh (None
    without a data-parallel group): one MAX reduce for every GEMM that
    reads ``x`` (``qeinsum(..., x_stat=)``). ``split`` names ``x``'s last
    dim where the rules may split it over the model group too (a
    row-parallel GEMM's input, ``act_ff`` or ``attn_out``): the statistic
    is then reduced over the batch and that split jointly."""
    if cfg is None or not cfg.is_quantized:
        return None
    group = batch_group() if split is None else joint_group("batch", split)
    return global_stat(x, cfg.act, cfg.act_scale_axis, group)


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
             scale_axis: Optional[int] = None,
             stat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Onto ``fmt``'s grid: Q_log for an LNS format, the miniature-float
    grid for an ``FPFormat`` (identity for ``fmt=None``); ``stat`` is a
    whole tensor's scale statistic (:func:`global_stat`)."""
    return x if fmt is None else _apply_format(x, fmt, scale_axis, stat)


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
                 scale_axis: Optional[int] = None,
                 stat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward: onto the grid (under ``stat``'s scale where given).
    Backward: identity (straight through)."""
    if fmt is None:
        return x
    return ste(x, quantize(x, fmt, scale_axis, stat))


def ste_quantize_sharded(xs, fmt: Format, group) -> list:
    """Per-tensor Q_A of each of ``xs`` (straight through), where each is
    this rank's shard of a tensor split over ``group``'s ranks (a head
    group, a data shard's rows, or both jointly): a tensor's scale is the
    whole tensor's, every rank's statistics max-reduced in one collective
    (``pow2_scale`` is monotone, so the max of the ranks' scales is the
    scale of the global absmax, exactly; a miniature float's scale is
    monotone in its absmax)."""
    stats = collectives.max_reduce(
        torch.stack([_stat(x, fmt, None) for x in xs]).detach(), group)
    return [ste(x, _apply_format(x, fmt, None, st))
            for x, st in zip(xs, stats)]


class _BackwardQuantize(torch.autograd.Function):
    """Identity forward; the gradient is put on ``fmt``'s grid (Q_E) and
    cast to ``cot_dtype``. The data-parallel group is taken in the forward:
    the backward may run on autograd's device thread, which does not see
    the forward's mesh context."""

    @staticmethod
    def forward(ctx, x, fmt, scale_axis, cot_dtype, group):
        ctx.fmt, ctx.scale_axis, ctx.cot_dtype = fmt, scale_axis, cot_dtype
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.fmt is not None:
            g = _apply_format(g, ctx.fmt, ctx.scale_axis, global_stat(
                g, ctx.fmt, ctx.scale_axis, ctx.group))
        if ctx.cot_dtype is not None:
            g = g.to(ctx.cot_dtype)
        return g, None, None, None, None


def backward_quantize(x: torch.Tensor, fmt: Optional[Format],
                      scale_axis: Optional[int] = None,
                      cot_dtype: Optional[torch.dtype] = None,
                      group=None) -> torch.Tensor:
    """Forward identity; backward quantizes the gradient (the paper's
    Q_E) and stores it in ``cot_dtype``. No node without a gradient. With
    ``group`` (the data-parallel group) the gradient's scale is the
    global batch's."""
    if not _needs_grad(x):
        return x
    return _BackwardQuantize.apply(x, fmt, scale_axis, cot_dtype, group)


def cot_boundary(x: torch.Tensor) -> torch.Tensor:
    """Forward identity; the gradient is cast to ``x.dtype``. The port's
    layers need no such boundary (autograd already returns a gradient in
    its input's dtype); this is the JAX function's counterpart for code
    that moves a gradient across dtypes itself."""
    return backward_quantize(x, None, None, x.dtype)


def quantize_grads(grads, cfg: Optional[QuantConfig], groups=None):
    """Q_G on a gradient tree (nested dicts and lists of tensors), per-tensor
    scales unless ``cfg.grad_scale_axis`` says otherwise. ``groups``, a
    tree of the same shape (None for a leaf every rank holds whole), names
    the group a leaf's shards split over: a per-tensor scale is then the
    whole leaf's, max-reduced over it (a per-output-channel scale of a
    column shard is the rank's own columns')."""
    if cfg is None or cfg.grad is None:
        return grads
    if isinstance(grads, dict):
        return {k: quantize_grads(v, cfg, None if groups is None
                                  else groups[k]) for k, v in grads.items()}
    if isinstance(grads, list):
        return [quantize_grads(v, cfg, None if groups is None else groups[i])
                for i, v in enumerate(grads)]
    return _apply_format(grads, cfg.grad, cfg.grad_scale_axis, global_stat(
        grads, cfg.grad, cfg.grad_scale_axis, groups))


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
                 wscale: torch.Tensor, x_scale: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None):
    """y = decode(Q_A(x)) @ decode(pw) * s_x * s_w through K1 and K2, with
    Q_A's scale K1's own or the given ``x_scale`` (the global batch's),
    in ``out_dtype`` (default x's). Returns ``(y, px, sx)``: the packed
    activation and its scale are the backward's residuals."""
    K = x.shape[-1]
    xm = x.reshape(-1, K).contiguous()
    if x_scale is None:
        px, sx = dispatch.encode_pack(xm, fmt, scale_axis=None)
    else:
        px, sx = dispatch.encode_pack(xm, fmt, scale_axis=None,
                                      scale=x_scale.reshape(1, 1))
    sw = wscale.reshape(1, -1).to(torch.float32).expand(1, pw.shape[1])
    y = dispatch.qmatmul(px, pw, fmt, scale_a=sx, scale_b=sw.contiguous(),
                         compute_dtype=x.dtype, out_dtype=out_dtype or x.dtype)
    return y.reshape(x.shape[:-1] + (pw.shape[1],)), px, sx


class _RoutedMatmul(torch.autograd.Function):
    """The routed GEMM with straight-through gradients
    (``_routed_fwd``/``_routed_bwd`` of the JAX package). ``delta`` is
    ignored by the primal; the backward returns dW into it."""

    @staticmethod
    def forward(ctx, fmt, x, delta, pw, wscale, x_scale, out_dtype):
        y, px, sx = _routed_impl(fmt, x, pw, wscale, x_scale, out_dtype)
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
        return None, dx, ddelta, None, None, None, None


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``jnp.einsum``'s promotion: operands of two
    float dtypes meet in the wider one (RWKV's f32 token-shift mixes meet
    bf16 weights when the mixes are not packed)."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    return torch.einsum(eq, x, w)


def qeinsum(eq: str, x: torch.Tensor, w, cfg: Optional[QuantConfig], *,
            x_stat: Optional[torch.Tensor] = None,
            out_axis: Optional[str] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``einsum(eq, Q_A(x), Q_W(w))`` with Q_E on the output's gradient;
    packed 2-D weights route through the kernels, dense ones take the
    fake-quant leg. A packed weight without a ``delta`` (serving) calls
    the kernels with no autograd machinery, as the JAX package does.
    Under a data-parallel mesh Q_A's and Q_E's scales are the global
    batch's; ``x_stat`` is Q_A's, reduced once by the caller where ``x``
    feeds several GEMMs (:func:`act_stat`). ``out_axis`` is the logical
    name of the output's last dim (a column-parallel GEMM's ``mlp`` or
    ``qkv_out``): where the active rules split it, ``w`` holds this
    rank's block of it and Q_E's scale also reduces over the ranks that
    split it. ``out_dtype`` (default x's) is the output's dtype: a
    row-parallel GEMM's partial product stays in f32, the accumulator's
    dtype, so the SUM over the model group rounds once, as one device's
    whole contraction does."""
    quant = cfg is not None and cfg.is_quantized
    group = batch_group() if quant else None
    if group is not None and x_stat is None:
        x_stat = global_stat(x, cfg.act, cfg.act_scale_axis, group)
    err_group = (joint_group("batch", out_axis) if quant and out_axis
                 else group)
    if is_lns_weight(w):
        if _routable(eq, w, cfg):
            pw = _forward_packed(w, cfg.weight)
            if w.delta is None:
                y = _routed_impl(cfg.weight, x, pw, w.scale, x_stat,
                                 out_dtype)[0]
            else:
                y = _RoutedMatmul.apply(cfg.weight, x, w.delta, pw, w.scale,
                                        x_stat, out_dtype)
            return backward_quantize(y, cfg.err, cfg.err_scale_axis, x.dtype,
                                     err_group)
        w = w.decode(x.dtype)      # per-leaf fallback; delta carries grads
    up = (lambda t: t) if out_dtype is None else (lambda t: t.to(out_dtype))
    if not quant:
        return backward_quantize(_einsum(eq, up(x), up(w)), None, None,
                                 x.dtype)
    if cfg.approx_lut is not None and cfg.weight is not None:
        from repro_torch.core.quant_training import approx_qeinsum
        y = up(approx_qeinsum(eq, x, w, cfg, x_scale=x_stat))
    else:
        xq = ste_quantize(x, cfg.act, cfg.act_scale_axis, x_stat)
        wq = ste_quantize(w, cfg.weight, cfg.weight_scale_axis)
        y = _einsum(eq, up(xq), up(wq))
    return backward_quantize(y, cfg.err, cfg.err_scale_axis, x.dtype,
                             err_group)
