"""Multi-base logarithmic number system (LNS), in PyTorch.

A value is ``sign * s * 2**(-e/gamma)``: ``e`` is an unsigned exponent code
in ``[0, 2**(bits-1) - 1]``, ``gamma`` a power-of-two base factor and ``s``
a power-of-two scale shared by a group of numbers (per tensor or per
channel). Code 0 is the largest magnitude, ``max_code`` the smallest.

Same semantics as ``repro.core.lns`` (the JAX reference), with two
container rules of its own:

* words of at most 8 bits are ``uint8``; wider words live in ``int32``
  (torch has no shifts on ``uint16``/``uint32`` on the CPU);
* exponent codes are ``int32``.

Rounding is to nearest with ties away from zero, ``floor(x + 0.5)``, the
convention the kernels share with the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "LNSFormat",
    "LNSWeight",
    "is_lns_weight",
    "pow2_scale",
    "compute_scale",
    "lns_encode",
    "lns_decode",
    "lns_quantize",
    "lns_pack",
    "lns_unpack",
    "lns_word_dtype",
    "lns_decode_packed",
    "lns_requant_packed",
    "lns_weight_encode",
]

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class LNSFormat:
    """A multi-base LNS format: ``bits`` total (1 sign + bits-1 exponent),
    base factor ``gamma`` (a power of two)."""

    bits: int = 8
    gamma: int = 8

    def __post_init__(self):
        if self.bits < 2 or self.bits > 32:
            raise ValueError(f"bits must be in [2,32], got {self.bits}")
        if self.gamma < 1 or (self.gamma & (self.gamma - 1)) != 0:
            raise ValueError(f"gamma must be a power of two, got {self.gamma}")

    @property
    def max_code(self) -> int:
        return (1 << (self.bits - 1)) - 1


def pow2_scale(absmax: torch.Tensor) -> torch.Tensor:
    """Snap a positive scale up to the next power of two (f32)."""
    a = torch.clamp_min(absmax.to(torch.float32), _TINY)
    return torch.exp2(torch.ceil(torch.log2(a)))


def compute_scale(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Absmax scale snapped to 2**k: per tensor (``axis=None``, a 0-d
    tensor) or keeping resolution on ``axis`` (an int or a tuple), reduced
    over every other axis with the dims kept."""
    xf = x.to(torch.float32).abs()
    if axis is None:
        return pow2_scale(xf.amax())
    keep = {a % x.dim() for a in ((axis,) if isinstance(axis, int) else axis)}
    reduce = tuple(i for i in range(x.dim()) if i not in keep)
    amax = xf.amax(dim=reduce, keepdim=True) if reduce else xf
    return pow2_scale(amax)


def lns_encode(x: torch.Tensor, fmt: LNSFormat, scale: torch.Tensor):
    """Real values -> ``(sign in {-1,+1} int8, code int32)``:
    ``code = clip(floor(-log2(max(|x|/s, tiny))·γ + 0.5), 0, max_code)``."""
    xf = x.to(torch.float32)
    sign = torch.where(xf < 0, -1, 1).to(torch.int8)
    mag = xf.abs() / scale
    e = -torch.log2(torch.clamp_min(mag, _TINY)) * fmt.gamma
    e = torch.floor(e + 0.5)
    e = torch.clamp(e, 0, fmt.max_code)
    return sign, e.to(torch.int32)


def lns_decode(sign: torch.Tensor, code: torch.Tensor, fmt: LNSFormat,
               scale, dtype=torch.float32) -> torch.Tensor:
    mag = torch.exp2(-code.to(torch.float32) / fmt.gamma)
    return (sign.to(torch.float32) * mag * scale).to(dtype)


def lns_quantize(x: torch.Tensor, fmt: LNSFormat, scale_axis=None,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q_log: fake-quantize ``x`` onto the LNS grid, keeping its dtype."""
    if scale is None:
        scale = compute_scale(x, axis=scale_axis)
    sign, code = lns_encode(x, fmt, scale)
    return lns_decode(sign, code, fmt, scale, dtype=x.dtype)


def lns_word_dtype(fmt: LNSFormat) -> torch.dtype:
    """``uint8`` up to 8 bits, else ``int32`` (no wide unsigned shifts)."""
    return torch.uint8 if fmt.bits <= 8 else torch.int32


def lns_pack(sign: torch.Tensor, code: torch.Tensor,
             fmt: LNSFormat) -> torch.Tensor:
    """One word per value: MSB = sign, low ``bits-1`` bits = code."""
    neg = (sign.to(torch.int32) < 0).to(torch.int64)
    word = (neg << (fmt.bits - 1)) | code.to(torch.int64)
    return word.to(lns_word_dtype(fmt))


def lns_unpack(packed: torch.Tensor, fmt: LNSFormat):
    w = packed.to(torch.int64)
    sign_bit = (w >> (fmt.bits - 1)) & 1
    code = w & fmt.max_code
    return (1 - 2 * sign_bit).to(torch.int8), code.to(torch.int32)


def lns_decode_packed(word: torch.Tensor, fmt: LNSFormat,
                      dtype=torch.float32) -> torch.Tensor:
    """Packed words -> unscaled reals ``±2^(-code/γ)`` in ``dtype``."""
    w = word.to(torch.int64)
    code = w & fmt.max_code
    sign = (1 - 2 * ((w >> (fmt.bits - 1)) & 1)).to(torch.float32)
    mag = torch.exp2(-code.to(torch.float32) / fmt.gamma)
    return (sign * mag).to(dtype)


def lns_requant_packed(packed: torch.Tensor, src: LNSFormat,
                       dst: LNSFormat) -> torch.Tensor:
    """Integer re-grid of packed words from ``src`` to ``dst``: upscale
    multiplies by the γ ratio, downscale rounds ``(c + r/2) // r``."""
    w = packed.to(torch.int64)
    sign_bit = (w >> (src.bits - 1)) & 1
    code = w & src.max_code
    if dst.gamma >= src.gamma:
        code = code * (dst.gamma // src.gamma)
    else:
        r = src.gamma // dst.gamma
        code = torch.div(code + r // 2, r, rounding_mode="floor")
    code = torch.clamp(code, 0, dst.max_code)
    return ((sign_bit << (dst.bits - 1)) | code).to(lns_word_dtype(dst))


class LNSWeight:
    """A weight stored as packed LNS words plus a power-of-two scale that
    broadcasts against the decoded tensor. Serving needs no tangent
    carrier, so unlike the JAX class there is no ``delta``."""

    __slots__ = ("packed", "scale", "fmt")

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 fmt: LNSFormat):
        self.packed = packed
        self.scale = scale
        self.fmt = fmt

    @property
    def shape(self):
        return self.packed.shape

    @property
    def ndim(self) -> int:
        return self.packed.dim()

    def __getitem__(self, i) -> "LNSWeight":
        """Slice a stacked weight along its leading (layer) axis."""
        return LNSWeight(self.packed[i], self.scale[i], self.fmt)

    def to(self, device) -> "LNSWeight":
        return LNSWeight(self.packed.to(device), self.scale.to(device),
                         self.fmt)

    def decode(self, dtype=torch.float32) -> torch.Tensor:
        """Dense view ``±s·2^(-code/γ)`` in ``dtype``."""
        return (lns_decode_packed(self.packed, self.fmt, torch.float32)
                * self.scale).to(dtype)

    def __repr__(self):
        return (f"LNSWeight(packed={tuple(self.packed.shape)}, "
                f"scale={tuple(self.scale.shape)}, fmt={self.fmt})")


def is_lns_weight(leaf) -> bool:
    return isinstance(leaf, LNSWeight)


def lns_weight_encode(x: torch.Tensor, fmt: LNSFormat, scale_axis=None,
                      scale: Optional[torch.Tensor] = None) -> LNSWeight:
    if scale is None:
        scale = compute_scale(x, axis=scale_axis)
    sign, code = lns_encode(x, fmt, scale)
    return LNSWeight(lns_pack(sign, code, fmt), scale, fmt)
