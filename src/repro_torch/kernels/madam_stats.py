"""The numerics stats of the fused Madam update (K4's epilogue), plain
torch: the counterparts of ``MADAM_STAT_KEYS``, ``requant_spec``,
``madam_stats_vec`` and ``madam_stats_dict`` in
``repro.kernels.madam_update``.

The stat vector has ``MADAM_STAT_WIDTH`` slots, summed over a leaf:

0. ``sat_lo``: steps rounding below code 0 (the overflow rail)
1. ``sat_hi``: steps rounding above ``max_code`` (the underflow rail)
2. ``dead``: nonzero intended steps whose code did not move
3. ``qerr_sum``: sum of ``|2^(-(code'-target)/γ) - 1|``
4. ``code_sum``: sum of the new codes
5. ``req_hi``: codes that will clamp when re-gridded to the forward format
6. and 7. reserved (zero)

Unlike the JAX package, which sums every slot in f32, the port keeps the
counts and ``code_sum`` as exact integers and only ``qerr_sum`` in f32;
the vector is f64 so it holds both.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.lns import LNSFormat

__all__ = ["MADAM_STAT_KEYS", "MADAM_STAT_WIDTH", "requant_spec",
           "madam_stats_vec", "madam_stats_dict"]

MADAM_STAT_KEYS = ("sat_lo", "sat_hi", "dead_frac", "qerr_rel",
                   "qerr_gap_ratio", "code_mean", "requant_sat_hi")
MADAM_STAT_WIDTH = 8


def requant_spec(src: LNSFormat,
                 dst: Optional[LNSFormat]) -> Optional[Tuple[int, int]]:
    """``(ratio, dst_max_code)`` of the forward re-grid stat, or ``None``
    when there is nothing to count: no forward format, the identity
    re-grid, or a widening one."""
    if dst is None or (src.bits, src.gamma) == (dst.bits, dst.gamma):
        return None
    if dst.gamma >= src.gamma:
        return None
    return (src.gamma // dst.gamma, dst.max_code)


def madam_stats_vec(code: torch.Tensor, target: torch.Tensor,
                    new_code: torch.Tensor, *, gamma: int, max_code: int,
                    requant: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """The summed stat vector (f64, ``MADAM_STAT_WIDTH``) of one leaf from
    its old codes (int), f32 targets and f32 new codes."""
    codef = code.to(torch.float32)
    rounded = torch.floor(target + 0.5)
    count = lambda m: m.sum(dtype=torch.int64).to(torch.float64)
    vec = torch.zeros(MADAM_STAT_WIDTH, dtype=torch.float64,
                      device=target.device)
    vec[0] = count(rounded < 0)
    vec[1] = count(rounded > max_code)
    vec[2] = count((new_code == codef) & (target != codef))
    vec[3] = torch.abs(torch.exp2(-(new_code - target) / gamma) - 1.0).sum()
    nc = new_code.to(torch.int64)
    vec[4] = nc.sum().to(torch.float64)
    if requant is not None:
        ratio, dst_max = requant
        vec[5] = count(torch.div(nc + ratio // 2, ratio,
                                 rounding_mode="floor") > dst_max)
    return vec


def madam_stats_dict(vec: torch.Tensor, n: int,
                     fmt: LNSFormat) -> Dict[str, torch.Tensor]:
    """A summed stat vector as the named per-leaf stats (0-d f32).
    ``qerr_gap_ratio`` is ``qerr_rel`` over the relative quantization gap
    ``2^(1/γ) - 1`` (round-to-nearest sits near a quarter of it)."""
    inv = 1.0 / float(max(n, 1))
    v = (vec * inv).to(torch.float32)
    out = {"sat_lo": v[0], "sat_hi": v[1], "dead_frac": v[2],
           "qerr_rel": v[3], "code_mean": v[4], "requant_sat_hi": v[5]}
    out["qerr_gap_ratio"] = out["qerr_rel"] / (2.0 ** (1.0 / fmt.gamma) - 1.0)
    return out
