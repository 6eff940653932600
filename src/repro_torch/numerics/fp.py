"""Low-precision floating-point fake-quantization, as ``repro.numerics.fp``.

The paper's FP8 (e4m3) and FP16 baselines (Tables 4, 5, 8): absmax
scaling onto the format's largest value, the mantissa rounded to
``man_bits`` half to even, exponents below the normal range kept on the
subnormal grid, clamped to the format's finite range, then scaled back.

The op chain is the JAX function's. Its one difference: the unit in the
last place is built as an exact power of two from the exponent's bits,
where JAX's ``exp2`` can land an f32 ulp off on XLA-CPU (ROADMAP H12).
This is not a cast to ``torch.float8_e4m3fn`` or ``float16``: the
format's largest value is the IEEE-style one (240 for e4m3, not 448),
and any ``(exp_bits, man_bits)`` pair is allowed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["FPFormat", "fp_quantize", "fp_absmax", "fp_round"]

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """An IEEE-like miniature float: 1 sign, ``exp_bits``, ``man_bits``;
    the largest value is ``2**bias * (2 - 2**-man_bits)``."""

    exp_bits: int = 4
    man_bits: int = 3

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def max_value(self) -> float:
        return float(2.0 ** self.bias * (2.0 - 2.0 ** (-self.man_bits)))

    @property
    def min_normal(self) -> float:
        return float(2.0 ** (1 - self.bias))


def fp_round(v: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Round f32 values, already scaled into the format's range, onto its
    grid: ``ulp = 2**(clip(floor(log2|v|), 1-bias, bias) - man_bits)``,
    ``round_half_even(v / ulp) * ulp``, clamped to ``±max_value``."""
    e = torch.floor(torch.log2(torch.clamp_min(v.abs(), _TINY)))
    e = torch.clamp(e, 1 - fmt.bias, fmt.bias)
    # 2**(e - man_bits) from its exponent field: exact, and a normal f32
    # for every format up to 8 exponent bits
    ulp = ((e.to(torch.int32) + (127 - fmt.man_bits)) << 23).view(
        torch.float32)
    q = torch.round(v / ulp) * ulp
    return torch.clamp(q, -fmt.max_value, fmt.max_value)


def fp_absmax(x: torch.Tensor,
              scale_axis: Optional[int] = None) -> torch.Tensor:
    """The f32 absmax an ``fp_quantize`` scale is made of: per tensor (0-d)
    or keeping ``scale_axis`` (reduced over every other dim, kept)."""
    xf = x.to(torch.float32)
    if scale_axis is None:
        return xf.abs().amax()
    keep = scale_axis % x.dim()
    return xf.abs().amax(
        dim=tuple(i for i in range(x.dim()) if i != keep), keepdim=True)


def fp_quantize(x: torch.Tensor, fmt: FPFormat,
                scale_axis: Optional[int] = None,
                absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fake-quantize ``x`` onto the miniature-float grid with an absmax
    scale (per tensor, or keeping resolution on ``scale_axis``), keeping
    its dtype. ``absmax`` (:func:`fp_absmax` of a whole tensor of which
    ``x`` is a part) replaces ``x``'s own."""
    xf = x.to(torch.float32)
    if absmax is None:
        absmax = fp_absmax(x, scale_axis)
    # divide by a tensor: ATen on CUDA turns a division by a Python scalar
    # into a multiply by its reciprocal, which rounds differently from the
    # CPU's (and JAX's) IEEE divide
    scale = torch.clamp_min(absmax, _TINY) / absmax.new_full(
        (), fmt.max_value)
    return (fp_round(xf / scale, fmt) * scale).to(x.dtype)
