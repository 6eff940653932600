"""Distributed gradient compression (``repro.optim.compression``).

Lifts the paper's Q_G into the data-parallel collective: each rank puts
its gradient on the LNS grid before the cross-rank sum, so the wire
carries a sign, a code and one scale a tensor (4x fewer bytes than f32).
Error feedback keeps each rank's residual (its contribution minus the
quantized one) and adds it to the next step's gradient. signSGD with a
majority vote is the 1-bit extreme.

Each function takes a ``torch.distributed`` process group (the mesh's
``data`` group; the default world with ``group=None``) and sums with
``all_reduce``, on NCCL for CUDA tensors and gloo for CPU ones. Trees
are nested dicts and lists of tensors. The per-tensor scale is the
port's exact power of two (the JAX package's is not on XLA-CPU: ROADMAP
H12), so a quantized contribution's codes equal JAX's and its values
differ by at most the scale's error.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lns import LNSFormat, lns_quantize
from repro_torch.tree import tree_map

__all__ = ["lns_compressed_psum", "sign_majority_psum",
           "error_feedback_update"]


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _compress(g: torch.Tensor, r: Optional[torch.Tensor], fmt: LNSFormat):
    """``(Q_log(g + r) per tensor, the new f32 residual or None)``."""
    local = g if r is None else g + r.to(g.dtype)
    q = lns_quantize(local, fmt, scale_axis=None)
    return q, (None if r is None else (local - q).to(torch.float32))


def lns_compressed_psum(grads, group=None, fmt: Optional[LNSFormat] = None,
                        residuals=None):
    """Sum a gradient tree over ``group`` with LNS-quantized contributions
    (per-tensor scale). With ``residuals`` (a tree like ``grads``) each
    rank keeps its error feedback. Returns ``(summed, new_residuals)``
    (None without ``residuals``)."""
    fmt = fmt or LNSFormat(bits=8, gamma=8)
    if residuals is None:
        return tree_map(lambda g: _sum(_compress(g, None, fmt)[0], group),
                        grads), None
    pairs = tree_map(lambda g, r: _compress(g, r, fmt), grads, residuals)
    summed = tree_map(lambda g, p: _sum(p[0], group), grads, pairs)
    return summed, tree_map(lambda g, p: p[1], grads, pairs)


def sign_majority_psum(grads, group=None):
    """signSGD with a majority vote: each rank votes ``sign(g)`` and the
    step is the sign of the summed votes (a tie gives 0). A rank that
    sends garbage flips only its own vote."""
    def leaf(g):
        votes = _sum(torch.sign(g).to(torch.float32), group)
        return torch.sign(votes).to(g.dtype)
    return tree_map(leaf, grads)


def error_feedback_update(grads, residuals, fmt: LNSFormat):
    """One error-feedback step with no collective: ``(quantized,
    new_residuals)``, each rank's ``Q_log(g + r)`` per tensor and its f32
    remainder."""
    pairs = tree_map(lambda g, r: _compress(g, r, fmt), grads, residuals)
    return (tree_map(lambda g, p: p[0], grads, pairs),
            tree_map(lambda g, p: p[1], grads, pairs))
