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
import functools
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
    "quantization_gap",
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
    def exponent_bits(self) -> int:
        return self.bits - 1

    @property
    def max_code(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def dynamic_range(self) -> float:
        """The width ``max_code/γ`` of the exponent range (0, max_code/γ)."""
        return self.max_code / self.gamma

    def with_bits(self, bits: int, keep_range: bool = True) -> "LNSFormat":
        """The format at another bitwidth. With ``keep_range`` the dynamic
        range ``(0, max_code/γ)`` stays: γ scales by ``2**(bits - B)``
        (paper §6.1.1, how Q_U is widened); without it γ stays."""
        gamma = self.gamma
        if keep_range and bits >= self.bits:
            gamma = self.gamma * (1 << (bits - self.bits))
        elif keep_range:
            gamma = max(1, self.gamma >> (self.bits - bits))
        return LNSFormat(bits=bits, gamma=gamma)


def pow2_scale(absmax: torch.Tensor) -> torch.Tensor:
    """Snap a positive scale up to the next power of two (f32)."""
    a = torch.clamp_min(absmax.to(torch.float32), _TINY)
    return torch.exp2(torch.ceil(torch.log2(a)))


# elementwise work on a tensor past this many elements runs a chunk of its
# leading axis at a time, so the f32 and int64 temporaries stay a chunk's
# size (gemma3-12b's 262,144 x 3840 head: 1.0e9 elements); the results
# are those of one whole pass (elementwise maps, and maxima, which are
# exact in any order)
_CHUNK_ELEMS = 1 << 26


def _chunks(x: torch.Tensor):
    """Slices of ``x``'s leading axis a chunk each, or ``[slice(None)]``
    when ``x`` is small."""
    if x.dim() == 0 or x.numel() <= _CHUNK_ELEMS:
        return [slice(None)]
    n = max(1, _CHUNK_ELEMS // max(1, x[0].numel()))
    return [slice(i, i + n) for i in range(0, x.shape[0], n)]


def _along(t: torch.Tensor, x: torch.Tensor, sl: slice) -> torch.Tensor:
    """The part of ``t`` (a scale) that meets chunk ``sl`` of ``x``: its
    slice where it runs along ``x``'s leading axis, else all of it."""
    if t.dim() == x.dim() and t.shape[0] == x.shape[0]:
        return t[sl]
    return t


def _chunked_map(fn, x: torch.Tensor, dtype: torch.dtype,
                 *aux: torch.Tensor) -> torch.Tensor:
    """``fn(x, *aux)`` for an elementwise ``fn`` (``aux`` broadcasts
    against ``x``), a chunk at a time."""
    parts = _chunks(x)
    if len(parts) == 1:
        return fn(x, *aux)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    for sl in parts:
        out[sl] = fn(x[sl], *(_along(t, x, sl) for t in aux))
    return out


def compute_scale(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Absmax scale snapped to 2**k: per tensor (``axis=None``, a 0-d
    tensor) or keeping resolution on ``axis`` (an int or a tuple), reduced
    over every other axis with the dims kept."""
    keep = set() if axis is None else {
        a % x.dim() for a in ((axis,) if isinstance(axis, int) else axis)}
    reduce = tuple(i for i in range(x.dim()) if i not in keep)

    def amax(c):
        cf = c.to(torch.float32).abs()
        if axis is None:
            return cf.amax()
        return cf.amax(dim=reduce, keepdim=True) if reduce else cf

    chunks = _chunks(x)
    if len(chunks) == 1:
        return pow2_scale(amax(x))
    parts = [amax(x[sl]) for sl in chunks]
    if 0 in keep:      # a chunk's rows keep their own maxima
        return pow2_scale(torch.cat(parts))
    return pow2_scale(functools.reduce(torch.maximum, parts))


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

    def q(c, s):
        return lns_decode(*lns_encode(c, fmt, s), fmt, s, dtype=x.dtype)

    return _chunked_map(q, x, x.dtype, scale)


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

    def regrid(p):
        w = p.to(torch.int64)
        sign_bit = (w >> (src.bits - 1)) & 1
        code = w & src.max_code
        if dst.gamma >= src.gamma:
            code = code * (dst.gamma // src.gamma)
        else:
            r = src.gamma // dst.gamma
            code = torch.div(code + r // 2, r, rounding_mode="floor")
        code = torch.clamp(code, 0, dst.max_code)
        return ((sign_bit << (dst.bits - 1)) | code).to(lns_word_dtype(dst))

    return _chunked_map(regrid, packed, lns_word_dtype(dst))


class LNSWeight:
    """A weight stored as packed LNS words plus a power-of-two scale that
    broadcasts against the decoded tensor.

    ``delta`` is the training tangent carrier, as in the JAX class: a
    zero dense tensor with ``requires_grad`` that the forward adds to the
    decoded weight (or, in the routed GEMM, ignores in the primal), so its
    ``.grad`` is dL/dW at W = decode(packed). ``None`` outside a loss.
    """

    __slots__ = ("packed", "scale", "delta", "fmt")

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 fmt: LNSFormat, delta: Optional[torch.Tensor] = None):
        self.packed = packed
        self.scale = scale
        self.fmt = fmt
        self.delta = delta

    @property
    def shape(self):
        return self.packed.shape

    @property
    def ndim(self) -> int:
        return self.packed.dim()

    def replace(self, **kw) -> "LNSWeight":
        d = {"packed": self.packed, "scale": self.scale, "fmt": self.fmt,
             "delta": self.delta}
        d.update(kw)
        return LNSWeight(**d)

    def __getitem__(self, i) -> "LNSWeight":
        """Slice a stacked weight along its leading (layer) axis; the
        slice of ``delta`` is a view, so its gradient lands in the
        stacked carrier's ``.grad``."""
        return LNSWeight(self.packed[i], self.scale[i], self.fmt,
                         None if self.delta is None else self.delta[i])

    def to(self, device) -> "LNSWeight":
        return LNSWeight(self.packed.to(device), self.scale.to(device),
                         self.fmt,
                         None if self.delta is None else self.delta.to(device))

    def decode(self, dtype=torch.float32) -> torch.Tensor:
        """Dense view ``±s·2^(-code/γ) (+ delta)`` in ``dtype``."""
        y = (lns_decode_packed(self.packed, self.fmt, torch.float32)
             * self.scale).to(dtype)
        if self.delta is not None:
            y = y + self.delta.to(dtype)
        return y

    def __repr__(self):
        return (f"LNSWeight(packed={tuple(self.packed.shape)}, "
                f"scale={tuple(self.scale.shape)}, "
                f"delta={'None' if self.delta is None else 'dense'}, "
                f"fmt={self.fmt})")


def is_lns_weight(leaf) -> bool:
    return isinstance(leaf, LNSWeight)


def lns_weight_encode(x: torch.Tensor, fmt: LNSFormat, scale_axis=None,
                      scale: Optional[torch.Tensor] = None) -> LNSWeight:
    """``x`` as packed words and a power-of-two scale, a chunk of the
    leading axis at a time where ``x`` is large."""
    if scale is None:
        scale = compute_scale(x, axis=scale_axis)
    packed = _chunked_map(lambda c, s: lns_pack(*lns_encode(c, fmt, s), fmt),
                          x, lns_word_dtype(fmt), scale)
    return LNSWeight(packed, scale, fmt)


def quantization_gap(x: torch.Tensor, fmt: LNSFormat) -> torch.Tensor:
    """Distance from ``|x|`` to the next representable value above it,
    ``|x|·(2^(1/γ) - 1)``: the gap that grows with the weight and breaks
    additive updates (paper Fig. 1). A diagnostic."""
    return x.abs() * (2.0 ** (1.0 / fmt.gamma) - 1.0)
