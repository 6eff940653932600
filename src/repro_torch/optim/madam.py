"""The part of LNS-Madam serving needs: packing a dense parameter tree
into packed LNS leaves. The multiplicative update itself comes with the
training slice."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.core.lns import LNSFormat, lns_weight_encode

__all__ = ["MadamConfig", "init_lns_params"]


@dataclasses.dataclass(frozen=True)
class MadamConfig:
    """Algorithm-1 settings; serving reads only ``update_format``, the
    format the weights are stored in (16-bit by default, 8-bit to serve
    on the forward grid)."""

    lr: float = 2.0 ** -7
    beta: float = 0.999
    update_format: LNSFormat = LNSFormat(bits=16, gamma=8 * (1 << 8))


def _lns_leaf_filter(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    """>=2-D tensors live in LNS, 1-D gains stay f32. A stacked ``period``
    leaf's leading layer axis does not count toward the rank."""
    stacked = "period" in path
    return leaf.dim() - (1 if stacked else 0) >= 2


def init_lns_params(params, cfg: MadamConfig,
                    leaf_filter: Callable = _lns_leaf_filter):
    """Encode a dense tree into packed :class:`LNSWeight` and f32 leaves.
    Every axis but the contraction axis (-2) keeps its own scale, so a
    stacked weight gets per-layer, per-output-channel scales that factor
    out of the routed GEMM."""
    fmt = cfg.update_format

    def enc(path, w):
        if isinstance(w, dict):
            return {k: enc(path + (k,), v) for k, v in w.items()}
        if not leaf_filter(path, w):
            return w.to(torch.float32)
        ax = tuple(i for i in range(w.dim()) if i != w.dim() - 2)
        return lns_weight_encode(w, fmt, scale_axis=ax)

    return enc((), params)
