"""Approximation-aware quantized GEMMs (paper App. B, Table 10), in
PyTorch.

Simulates the *hybrid conversion approximation* inside a dot product:
every product term ``2**(p/γ)`` is decoded with the Mitchell/LUT
approximation before accumulation. The approximation's multiplicative
error depends only on the product-exponent remainder ``r = p mod γ``, so
the dot product splits into γ exact GEMMs bucketed by the weight code's
remainder, with the activation pre-multiplied by the bin's error factor:

    y = Σ_j einsum( x·δ((p_x + j) mod γ), w·[p_w mod γ == j] )

A bit-faithful simulation of the approximate datapath at γ× the GEMM
cost, as ``repro.core.quant_training``. The γ products are plain large
f32 einsums (JAX leaves them to XLA); they run in full f32, since the
port never turns TF32 on (ROADMAP H3).
"""
from __future__ import annotations

import torch

from repro_torch.core import conversion
from repro_torch.core.lns import LNSFormat, compute_scale, lns_decode, lns_encode
from repro_torch.core.quantizer import ste

__all__ = ["approx_qeinsum", "approx_value", "approx_product_values"]


def _positive_codes(code: torch.Tensor, fmt: LNSFormat) -> torch.Tensor:
    """Bottom-anchored positive codes, the hardware's storage convention:
    value = s · 2**(-e/γ) = (s·2**(-max_code/γ)) · 2**((max_code-e)/γ)."""
    return fmt.max_code - code.to(torch.int32)


def approx_product_values(ex: torch.Tensor, ew: torch.Tensor, fmt: LNSFormat,
                          lut_entries: int) -> torch.Tensor:
    """The hybrid approximation of ``2**((ex+ew)/γ)`` for two positive
    codes, elementwise (the tests' reference; no bucketing)."""
    p = ex.to(torch.int32) + ew.to(torch.int32)
    return conversion.exp2_hybrid(p, fmt.gamma, lut_entries)


def approx_value(eq: str, x: torch.Tensor, w: torch.Tensor, cfg,
                 x_scale=None):
    """The approximate product and its operands, with no autograd graph:
    ``(y_approx, xq, wq)``, where ``xq = Q_A(x)`` and ``wq = Q_W(w)`` are
    the f32 decodes and ``y_approx`` sums the γ bucketed einsums.
    ``x_scale`` replaces Q_A's own scale of ``x`` (a data-parallel rank's
    is the global batch's)."""
    fmt: LNSFormat = cfg.weight
    afmt: LNSFormat = cfg.act or fmt
    gamma = fmt.gamma
    with torch.no_grad():
        sx_scale = (compute_scale(x, axis=cfg.act_scale_axis)
                    if x_scale is None else x_scale)
        sw_scale = compute_scale(w, axis=cfg.weight_scale_axis)
        sx, ex = lns_encode(x, afmt, sx_scale)
        sw, ew = lns_encode(w, fmt, sw_scale)
        xq = lns_decode(sx, ex, afmt, sx_scale, dtype=torch.float32)
        wq = lns_decode(sw, ew, fmt, sw_scale, dtype=torch.float32)
        # positive (bottom-anchored) codes; product remainder (px+pw) mod γ
        px = _positive_codes(ex, afmt)
        rw = _positive_codes(ew, fmt) % gamma
        y_approx = None
        for j in range(gamma):
            delta = conversion.approx_decode_factor((px + j) % gamma, gamma,
                                                    cfg.approx_lut)
            term = torch.einsum(eq, xq * delta,
                                torch.where(rw == j, wq, 0.0))
            y_approx = term if y_approx is None else y_approx + term
    return y_approx, xq, wq


def approx_qeinsum(eq: str, x: torch.Tensor, w: torch.Tensor,
                   cfg, x_scale=None) -> torch.Tensor:
    """Quantized einsum whose forward accumulates with the approximate
    conversion (``cfg.approx_lut`` LUT entries) and whose backward is the
    straight-through gradient of the exact fake-quantized einsum
    ``einsum(Q_A(x), Q_W(w))``.

    ``y_approx`` (:func:`approx_value`) holds no graph and enters as
    ``y_exact + (y_approx - y_exact).detach()`` (JAX's ``stop_gradient``),
    so autograd keeps no γ bucketed copies of the operands.

    The gradient reaches ``x`` and ``w`` through ``Q_A``/``Q_W`` as
    identities, as the JAX function's docstring states. The JAX function
    itself builds ``y_exact`` from the decoded codes, through which no
    gradient flows, so its GEMMs pass back zeros (ROADMAP H9); the forward
    values are the same.
    """
    y_approx, xq, wq = approx_value(eq, x, w, cfg, x_scale)
    y_exact = torch.einsum(eq, ste(x.to(torch.float32), xq),
                           ste(w.to(torch.float32), wq))
    y = y_exact + (y_approx - y_exact).detach()
    return y.to(x.dtype)
