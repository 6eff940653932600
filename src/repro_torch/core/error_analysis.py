"""Weight-update quantization-error analysis (paper §4.2, Fig. 4, App. A),
as ``repro.core.error_analysis``.

The simplified quantizer of Eq. 11 (no scale, no clamp, stochastic
rounding) and the four learning rules (GD, MUL, signMUL, Madam), measuring
r_t = || log2|W_q| - log2|W_new| ||² beside the bounds of Theorems 1/2
and Lemma 1.

Randomness comes from an explicit ``torch.Generator`` where JAX takes a
key. :func:`simplified_qlog` and :func:`measure_all` also take the
uniforms themselves (``u=``), so a caller can feed another framework's
draws and compare the rest of the computation.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

__all__ = [
    "simplified_qlog",
    "update_gd",
    "update_mul",
    "update_signmul",
    "update_madam",
    "quant_error",
    "theoretical_bounds",
    "snap_to_grid",
    "measure_all",
]

_TINY = torch.finfo(torch.float32).tiny
RULES = ("gd", "mul", "signmul", "madam")


def _log2_mag(x: torch.Tensor) -> torch.Tensor:
    return torch.log2(torch.clamp_min(x.abs(), _TINY))


def simplified_qlog(generator: Optional[torch.Generator], x: torch.Tensor,
                    gamma: float, *, u: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Eq. 11: Q(x) = sign(x)·2**(SR(γ·log2|x|)/γ), no scale, no clamp.
    The rounding's uniforms are ``u`` when given, else drawn from
    ``generator`` in [0, 1)."""
    e = gamma * _log2_mag(x)
    floor = torch.floor(e)
    if u is None:
        u = torch.rand(e.shape, generator=generator, dtype=e.dtype,
                       device=e.device)
    e_sr = floor + (u <= (e - floor)).to(e.dtype)
    return torch.sign(x) * torch.exp2(e_sr / gamma)


def update_gd(w, g, eta):
    """U_GD = W - η∇W."""
    return w - eta * g


def update_mul(w, g, eta):
    """U_MUL (Eq. 6): sign(W) ⊙ 2**(W̃ - η ∇W ⊙ sign(W))."""
    return torch.sign(w) * torch.exp2(_log2_mag(w) - eta * g * torch.sign(w))


def update_signmul(w, g, eta):
    """U_signMUL (Lemma 1): only the sign of the gradient."""
    return torch.sign(w) * torch.exp2(
        _log2_mag(w) - eta * torch.sign(g) * torch.sign(w))


def update_madam(w, g, g2, eta, beta=0.999):
    """Madam (Eq. 9) with second-moment normalization. Returns (w', g2')."""
    g2 = (1.0 - beta) * g * g + beta * g2
    gstar = g * torch.rsqrt(g2 + 1e-30)
    return (torch.sign(w) * torch.exp2(_log2_mag(w) - eta * gstar
                                       * torch.sign(w)), g2)


def quant_error(w_new: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """r_t = ||log2|W_q| - log2|W_new|||² (the paper's §4.2 objective)."""
    d = _log2_mag(w_q) - _log2_mag(w_new)
    return torch.sum(d * d)


def theoretical_bounds(w, g, eta, gamma) -> Dict[str, object]:
    """Upper bounds of Theorems 1/2 (0-d tensors) and Lemma 1 (a float)
    for the given state."""
    d = w.numel()
    sqrt_d = math.sqrt(d)
    gd_inner = torch.clamp_min((w - eta * g).abs(), _TINY)
    return {
        "gd": sqrt_d / gamma * torch.linalg.vector_norm(
            torch.log2(gd_inner).reshape(-1)),
        "mul": sqrt_d * eta / gamma * torch.linalg.vector_norm(
            g.reshape(-1)),
        "signmul": d * eta / gamma,
    }


def snap_to_grid(w: torch.Tensor, gamma: float) -> torch.Tensor:
    """Round weights onto the γ log-grid (deterministic, half to even)."""
    return torch.sign(w) * torch.exp2(torch.round(gamma * _log2_mag(w))
                                      / gamma)


def measure_all(generator: Optional[torch.Generator], w: torch.Tensor,
                g: torch.Tensor, eta: float, gamma: float,
                g2: Optional[torch.Tensor] = None, *,
                u: Optional[Sequence[torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """One Fig.-4 measurement: r_t for each rule under Eq.-11
    quantization. ``w`` is first snapped onto the grid (in quantized
    training the current weights are grid points). ``u``: the four rules'
    uniforms in the order gd, mul, signmul, madam; else each rule draws
    its own from ``generator``, in that order."""
    w = snap_to_grid(w, gamma)
    if g2 is None:
        g2 = torch.ones_like(w)
    new = {"gd": update_gd(w, g, eta), "mul": update_mul(w, g, eta),
           "signmul": update_signmul(w, g, eta),
           "madam": update_madam(w, g, g2, eta)[0]}
    out = {}
    for i, name in enumerate(RULES):
        q = simplified_qlog(generator, new[name], gamma,
                            u=None if u is None else u[i])
        out[name] = quant_error(new[name], q)
    return out
