"""Rounding primitives (paper Eq. 10), as in ``repro.numerics.rounding``.

Stochastic rounding is the optional Q_U mode; the deployed datapath rounds
to nearest. The random numbers come from an explicit ``torch.Generator``:
the port cannot replay ``jax.random``'s stream, so seeded replay is the
port's own contract.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["stochastic_round", "round_nearest"]


def stochastic_round(x: torch.Tensor,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Unbiased stochastic rounding: ``floor(x) + Bernoulli(frac(x))``,
    with ``u <= frac`` for a uniform ``u`` in [0, 1), as the JAX version
    draws it."""
    floor = torch.floor(x)
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return floor + (u <= (x.to(torch.float32) - floor)).to(x.dtype)


def round_nearest(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties away from zero (as the kernels round)."""
    return torch.floor(x + 0.5)
