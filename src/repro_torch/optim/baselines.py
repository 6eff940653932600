"""Baseline optimizers (paper §6.1.2), as ``repro.optim.baselines``:
SGD with momentum and AdamW, and the *quantized weight update* wrapper of
Eq. 4 that the Fig.-7 comparison runs them under (W <- Q_log(U(W, ∇W))
at B_U bits).

Each is an ``(init, update)`` pair over a tree of dense tensors;
``update(grads, state, params, generator=None)`` returns ``(params,
state)``. Every leaf is stepped in f32 and cast back to its dtype, under
``torch.no_grad()``, on the parameters' device. ``count`` is a host int,
so no device sync reads it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.lns import LNSFormat, lns_quantize
from repro_torch.kernels.ref import bias_correction
from repro_torch.tree import leaves, tree_get, tree_map, tree_set

__all__ = ["SGDState", "AdamWState", "sgd", "adamw", "quantized_update"]


class SGDState(NamedTuple):
    momentum: Any
    count: int


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: int


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd(lr: float = 0.1, momentum: float = 0.9, weight_decay: float = 1e-4):
    """SGD with momentum and weight decay folded into the gradient (the
    paper's CV default)."""

    def init(params) -> SGDState:
        return SGDState(momentum=_zeros_f32(params), count=0)

    @torch.no_grad()
    def update(grads, state: SGDState, params,
               generator: Optional[torch.Generator] = None):
        new_p: Dict = {}
        new_m: Dict = {}
        for path, p in leaves(params):
            pf = p.to(torch.float32)
            g = tree_get(grads, path).to(torch.float32) + weight_decay * pf
            m = momentum * tree_get(state.momentum, path) + g
            tree_set(new_p, path, (pf - lr * m).to(p.dtype))
            tree_set(new_m, path, m)
        return new_p, SGDState(momentum=new_m, count=state.count + 1)

    return init, update


def adamw(lr: float = 3e-5, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01):
    """AdamW (the paper's NLP default). The bias corrections ``1 - b**c``
    are the host's f32 pow, as the JAX package rounds them (H6)."""

    def init(params) -> AdamWState:
        return AdamWState(m=_zeros_f32(params), v=_zeros_f32(params),
                          count=0)

    @torch.no_grad()
    def update(grads, state: AdamWState, params,
               generator: Optional[torch.Generator] = None):
        c = state.count + 1
        bc1, bc2 = bias_correction(b1, c), bias_correction(b2, c)
        new_p: Dict = {}
        new_m: Dict = {}
        new_v: Dict = {}
        for path, p in leaves(params):
            g = tree_get(grads, path).to(torch.float32)
            m = b1 * tree_get(state.m, path) + (1 - b1) * g
            v = b2 * tree_get(state.v, path) + (1 - b2) * g * g
            mh = m / bc1
            vh = v / bc2
            pf = p.to(torch.float32)
            new = pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
            tree_set(new_p, path, new.to(p.dtype))
            tree_set(new_m, path, m)
            tree_set(new_v, path, v)
        return new_p, AdamWState(m=new_m, v=new_v, count=c)

    return init, update


def quantized_update(opt, fmt: LNSFormat, scale_axis: Optional[int] = -1):
    """Eq. 4: put every updated leaf of rank >= 2 on ``fmt``'s LNS grid
    (Q_log at ``scale_axis``); leaves of rank < 2 stay as they are (the
    same carve-out as Madam on LNS). SGD and AdamW degrade under it
    because their steps are not proportional to the weights (Thm. 1)."""
    init, update = opt

    def qupdate(grads, state, params,
                generator: Optional[torch.Generator] = None):
        new_params, new_state = update(grads, state, params, generator)
        return tree_map(lambda p: p if p.dim() < 2 else lns_quantize(
            p, fmt, scale_axis=scale_axis), new_params), new_state

    return init, qupdate
