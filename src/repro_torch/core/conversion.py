"""LNS <-> integer (linear) conversion, in PyTorch (paper §2.2, §2.3,
Appendix B).

The expensive step of an LNS dot product is converting the product
exponent ``2**(p/γ)`` to linear form for accumulation. The paper splits it

    2**(p/γ) = 2**q · 2**(r/γ),   q = p >> b,  r = p & (γ-1),  γ = 2**b

into a shift (quotient) and a γ-entry lookup (remainder), optionally shrunk
further by the *hybrid* Mitchell approximation (App. B):

    2**(r/γ) = 2**(r_M/γ) · 2**(r_L/γ) ≈ 2**(r_M/γ) · (1 + r_L/γ)

with ``b_m`` remainder MSBs looked up (``lut_entries = 2**b_m``) and the
``b_l = b - b_m`` LSBs approximated. ``lut_entries == γ`` is the exact
conversion, ``lut_entries == 1`` pure Mitchell.

Same functions and semantics as ``repro.core.conversion`` (the JAX
reference). The LUT constructors are the same numpy code, so their tables are
bit-identical and the K8 wrapper uploads them to the kernel as they are.
The integer fixed-point functions work on int32 tensors and are bit-equal
to the reference. The float functions call ``exp2`` in f32, which differs
by a few ulp across frameworks (ROADMAP H1).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "remainder_lut",
    "remainder_lut_int",
    "remainder_lut_neg",
    "remainder_lut_neg_int",
    "remainder_lut_neg_shifted_int",
    "exp2_exact",
    "exp2_hybrid",
    "exp2_exact_fixed",
    "exp2_hybrid_fixed",
    "exp2_neg_exact_fixed",
    "exp2_neg_hybrid_fixed",
    "approx_decode_factor",
    "device_table",
]


def _check(gamma: int, lut_entries: int | None = None) -> int:
    if gamma < 1 or gamma & (gamma - 1):
        raise ValueError(f"gamma must be a power of two, got {gamma}")
    b = int(gamma).bit_length() - 1
    if lut_entries is not None:
        if lut_entries < 1 or lut_entries & (lut_entries - 1) or lut_entries > gamma:
            raise ValueError(
                f"lut_entries must be a power of two in [1, gamma], got {lut_entries}"
            )
    return b


def _lsb_bits(b: int, lut_entries: int) -> int:
    """``b_l``: the remainder LSBs the Mitchell term approximates."""
    return b - (int(lut_entries).bit_length() - 1)


_TABLES = {}


def device_table(make_lut, *args, device) -> torch.Tensor:
    """``make_lut(*args)`` (one of the ``remainder_lut*`` functions) as a
    tensor on ``device``, uploaded once and kept: the datapath functions
    then copy nothing from the host per call, so they run inside a CUDA
    graph. The tensor is shared; callers do not write to it."""
    key = (make_lut.__name__, args, str(torch.device(device)))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(make_lut(*args)).to(device)
    return _TABLES[key]


def remainder_lut(gamma: int, lut_entries: int | None = None) -> np.ndarray:
    """The γ (or ``lut_entries``) remainder constants ``2**(i·step/γ)``,
    step = γ / entries (f32)."""
    _check(gamma, lut_entries)
    n = gamma if lut_entries is None else lut_entries
    step = gamma // n
    return np.exp2(np.arange(n) * step / gamma).astype(np.float32)


def remainder_lut_int(gamma: int, frac_bits: int, lut_entries: int | None = None) -> np.ndarray:
    """Fixed-point LUT: ``round(2**(i·step/γ) · 2**frac_bits)`` (int32)."""
    return np.round(remainder_lut(gamma, lut_entries) * (1 << frac_bits)).astype(np.int32)


def remainder_lut_neg(gamma: int, lut_entries: int | None = None) -> np.ndarray:
    """Negative-convention constants ``2**(-i·step/γ)`` in (0.5, 1]: the
    storage format keeps negated exponents, so the datapath uses these with
    a *right* shift by the quotient."""
    _check(gamma, lut_entries)
    n = gamma if lut_entries is None else lut_entries
    step = gamma // n
    return np.exp2(-np.arange(n) * step / gamma).astype(np.float32)


def remainder_lut_neg_int(gamma: int, frac_bits: int, lut_entries: int | None = None) -> np.ndarray:
    """Fixed-point negative LUT: ``round(2**(-i·step/γ) · 2**frac_bits)``."""
    return np.round(remainder_lut_neg(gamma, lut_entries) * (1 << frac_bits)).astype(np.int32)


def remainder_lut_neg_shifted_int(gamma: int, frac_bits: int,
                                  lut_entries: int) -> np.ndarray:
    """Offset LUT of the negative-convention hybrid: entry i holds
    ``round(2**(-(i+1)·step/γ) · 2**frac_bits)``, one LSB interval beyond
    the plain negative LUT, so Mitchell applies to a positive fraction."""
    _check(gamma, lut_entries)
    step = gamma // lut_entries
    return np.round(
        np.exp2(-(np.arange(lut_entries) + 1.0) * step / gamma)
        * (1 << frac_bits)).astype(np.int32)


def _split(p: torch.Tensor, gamma: int):
    b = _check(gamma)
    p = p.to(torch.int32)
    return b, p >> b, p & (gamma - 1)


def exp2_exact(p: torch.Tensor, gamma: int) -> torch.Tensor:
    """Exact conversion ``2**(p/γ)`` of non-negative integer exponents via
    quotient shift + remainder LUT (f32)."""
    _, q, r = _split(p, gamma)
    lut = device_table(remainder_lut, gamma, device=p.device)
    return torch.exp2(q.to(torch.float32)) * lut[r]


def exp2_hybrid(p: torch.Tensor, gamma: int, lut_entries: int) -> torch.Tensor:
    """Hybrid Mitchell/LUT conversion (paper Eq. 16), f32:
    ``2**q · LUT[r_M] · (1 + r_L/γ)``."""
    b = _check(gamma, lut_entries)
    _, q, r = _split(p, gamma)
    b_l = _lsb_bits(b, lut_entries)
    r_m = r >> b_l
    r_l = r & ((1 << b_l) - 1)
    lut = device_table(remainder_lut, gamma, lut_entries, device=p.device)
    mitchell = 1.0 + r_l.to(torch.float32) / gamma
    return torch.exp2(q.to(torch.float32)) * lut[r_m] * mitchell


def exp2_exact_fixed(p: torch.Tensor, gamma: int, frac_bits: int = 16) -> torch.Tensor:
    """Bit-exact integer datapath ``LUT_int[r] << q`` (int32), in
    ``frac_bits`` fixed point; callers keep
    ``q + frac_bits + log2(max LUT) < 31``."""
    _, q, r = _split(p, gamma)
    lut = device_table(remainder_lut_int, gamma, frac_bits, device=p.device)
    return lut[r] << q


def exp2_hybrid_fixed(p: torch.Tensor, gamma: int, lut_entries: int, frac_bits: int = 16) -> torch.Tensor:
    """Bit-exact hybrid datapath (App. B):
    ``((LUT_int[r_M]·(γ + r_L)) >> b) << q`` (int32)."""
    b = _check(gamma, lut_entries)
    _, q, r = _split(p, gamma)
    b_l = _lsb_bits(b, lut_entries)
    r_m = r >> b_l
    r_l = r & ((1 << b_l) - 1)
    lut = device_table(remainder_lut_int, gamma, frac_bits, lut_entries,
                       device=p.device)
    v = lut[r_m] * (gamma + r_l)  # frac_bits + b fixed point
    # the reference shifts logically; v >= 0, so the arithmetic shift of
    # an int32 gives the same bits
    return (v >> b) << q


def exp2_neg_exact_fixed(m: torch.Tensor, gamma: int, frac_bits: int = 16) -> torch.Tensor:
    """Bit-exact negative-exponent datapath ``LUTneg_int[r] >> q`` (int32)
    for the non-negative negated product exponent ``m`` (value
    ``2**(-m/γ)``); quotients past ``frac_bits`` underflow to 0 as a
    fixed-point datapath drops sub-LSB products."""
    _, q, r = _split(m, gamma)
    q = torch.clamp_max(q, 31)
    lut = device_table(remainder_lut_neg_int, gamma, frac_bits, device=m.device)
    # logical shift in the reference; the LUT entries are non-negative
    return lut[r] >> q


def exp2_neg_hybrid_fixed(m: torch.Tensor, gamma: int, lut_entries: int, frac_bits: int = 16) -> torch.Tensor:
    """Bit-exact hybrid (App. B) in the negative convention: Mitchell on
    the complement of the LSB remainder through the shifted LUT,

        2**(-r_L/γ) ≈ 2**(-2^b_l/γ) · (1 + (2^b_l - r_L)/γ),

    then the base-factor shift and the quotient right shift (int32)."""
    b = _check(gamma, lut_entries)
    _, q, r = _split(m, gamma)
    q = torch.clamp_max(q, 31)
    b_l = _lsb_bits(b, lut_entries)
    r_m = r >> b_l
    r_l = r & ((1 << b_l) - 1)
    lut = device_table(remainder_lut_neg_shifted_int, gamma, frac_bits,
                       lut_entries, device=m.device)
    v = lut[r_m] * (gamma + (1 << b_l) - r_l)  # frac_bits + b fixed point
    # logical shifts in the reference; v >= 0
    return (v >> b) >> q


def approx_decode_factor(r: torch.Tensor, gamma: int, lut_entries: int) -> torch.Tensor:
    """Multiplicative error ``approx(2**(r/γ)) / 2**(r/γ)`` of the hybrid
    conversion per remainder bin ``r`` (f32), for the
    approximation-aware-training simulation."""
    b = _check(gamma, lut_entries)
    r = r.to(torch.int32)
    b_l = _lsb_bits(b, lut_entries)
    r_m = r >> b_l
    r_l = r & ((1 << b_l) - 1)
    lut = device_table(remainder_lut, gamma, lut_entries, device=r.device)
    approx = lut[r_m] * (1.0 + r_l.to(torch.float32) / gamma)
    exact = torch.exp2(r.to(torch.float32) / gamma)
    return approx / exact
