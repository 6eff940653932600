"""Per-layer LNS numerics stats computed inside the train step.

The in-graph helpers of ``repro.obs.numerics``: stable layer names for a
parameter path, the encode-site rail-saturation stats of the gradient
quantizer Q_G, and the serving tree's code-rail occupancy
(``tree_code_stats``, read by ``Engine.numerics_snapshot``). The
update-site stats come from the Madam kernel's epilogue
(``kernels/madam_stats.py``). The host-side observer and the trace
export belong to the observability slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.lns import LNSFormat, compute_scale, is_lns_weight
from repro_torch.tree import leaves

__all__ = ["path_name", "encode_sat_stats", "grad_encode_stats",
           "tree_code_stats"]

_TINY = torch.finfo(torch.float32).tiny


def path_name(path: Tuple[str, ...]) -> str:
    """A parameter path as the dotted layer name the JAX package uses
    (``period.pos0.attn.wq``)."""
    return ".".join(str(p) for p in path) or "root"


def encode_sat_stats(x: torch.Tensor, fmt: LNSFormat,
                     scale_axis=None) -> Dict[str, torch.Tensor]:
    """Rail-saturation fractions of encoding ``x`` into ``fmt``: the
    pre-clip rounded exponent, re-derived as ``lns_encode`` computes it,
    below code 0 (``sat_lo``) or above ``max_code`` (``sat_hi``), and the
    mean log2 of the pow2 scale (0-d f32 tensors)."""
    scale = compute_scale(x, axis=scale_axis)
    mag = x.to(torch.float32).abs() / scale
    e = -torch.log2(torch.clamp_min(mag, _TINY)) * fmt.gamma
    rounded = torch.floor(e + 0.5)
    inv = 1.0 / float(max(x.numel(), 1))
    return {
        "sat_lo": (rounded < 0).to(torch.float32).sum() * inv,
        "sat_hi": (rounded > fmt.max_code).to(torch.float32).sum() * inv,
        "scale_log2": torch.log2(scale).mean(),
    }


def grad_encode_stats(grads, qcfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """Encode-site stats of Q_G for every >=2-D gradient leaf, keyed by
    layer name; ``{}`` when the config quantizes no gradients."""
    fmt = getattr(qcfg, "grad", None)
    if not isinstance(fmt, LNSFormat):
        return {}
    axis = getattr(qcfg, "grad_scale_axis", None)
    return {path_name(p): encode_sat_stats(g, fmt, axis)
            for p, g in leaves(grads) if g.dim() >= 2}


def tree_code_stats(params) -> Dict[str, Any]:
    """Code-rail occupancy of every packed leaf: the share of codes at 0
    (the largest magnitude) and at ``max_code`` (the flush-to-zero rail)
    and the mean code, over all ``elements``. Codes piling at a rail mean
    the serving copy lost resolution. One pass over the words on their
    device, three integer sums a leaf back to the host (int64, so a
    full-width tree's code sum does not wrap)."""
    tot = lo = hi = code_sum = 0
    for _, leaf in leaves(params):
        if not is_lns_weight(leaf):
            continue
        fmt = leaf.fmt
        code = leaf.packed.to(torch.int32) & fmt.max_code
        lo += int((code == 0).sum())
        hi += int((code == fmt.max_code).sum())
        code_sum += int(code.sum())
        tot += code.numel()
    if tot == 0:
        return {"elements": 0}
    return {"elements": tot, "code0_frac": lo / tot,
            "maxcode_frac": hi / tot, "code_mean": code_sum / tot}
