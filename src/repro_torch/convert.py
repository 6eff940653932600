"""Carry parameters across from the JAX package's checkpoint layout.

The input is what ``repro.checkpoint.CheckpointManager`` writes: a flat
dict of numpy arrays keyed by ``::``-joined pytree paths, where a packed
weight is two leaves, ``<path>::packed`` and ``<path>::scale``. A whole
train-state dict (``params::...``, ``opt::...``, ``step``) is accepted;
only the ``params`` subtree is read. The output is the port's parameter
dict: nested dicts of tensors and :class:`LNSWeight` leaves.

Packed words wider than 8 bits arrive as ``uint16``/``uint32`` and are
kept in ``int32`` (torch has no shifts on wide unsigned types on the CPU).
This module reads numpy only; it never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.lns import LNSFormat, LNSWeight
from repro_torch.device import resolve_device

__all__ = ["SEP", "params_from_flat"]

SEP = "::"


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype in (np.uint16, np.uint32):
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _build(node: Dict[str, Any], fmt: LNSFormat, device):
    if set(node) >= {"packed", "scale"} and not isinstance(node["packed"],
                                                           dict):
        return LNSWeight(_tensor(node["packed"], device),
                         _tensor(node["scale"], device).to(torch.float32),
                         fmt)
    return {k: (_build(v, fmt, device) if isinstance(v, dict)
                else _tensor(v, device)) for k, v in node.items()}


def params_from_flat(flat: Dict[str, np.ndarray], fmt: LNSFormat, *,
                     device=None) -> Dict[str, Any]:
    """Nested port params from ``::``-keyed arrays. ``fmt`` is the LNS
    format the packed words were written in (the layout stores no
    format)."""
    dev = resolve_device(device)
    keys = list(flat)
    prefix = "params" + SEP
    if any(k.startswith(prefix) for k in keys):
        flat = {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return _build(tree, fmt, dev)

