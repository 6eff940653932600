"""Carry parameters across from the JAX package's checkpoint layout.

The input is what ``repro.checkpoint.CheckpointManager`` writes: a flat
dict of numpy arrays keyed by ``::``-joined pytree paths, where a packed
weight is two leaves, ``<path>::packed`` and ``<path>::scale``, and a
list's items are keyed by their index (``prefix::0::...``).
:func:`params_from_flat` reads the ``params`` subtree (or a bare
parameter dict) into the port's parameter dict: nested dicts (and the
lists the JAX pytree holds) of tensors and :class:`LNSWeight` leaves. :func:`train_state_from_flat` reads a
whole train state (``params::…``, ``opt::g2::…``, ``opt::count``,
``step``) into a :class:`~repro_torch.training.steps.TrainState`.

Packed words wider than 8 bits arrive as ``uint16``/``uint32`` and are
kept in ``int32`` (torch has no shifts on wide unsigned types on the CPU);
dense ``bfloat16`` leaves (numpy's ``ml_dtypes`` type) keep their bits.
This module reads numpy only; it never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.lns import LNSFormat, LNSWeight
from repro_torch.device import resolve_device

__all__ = ["SEP", "params_from_flat", "train_state_from_flat"]

SEP = "::"


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype in (np.uint16, np.uint32):
        a = a.astype(np.int32)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: its bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _build(node: Dict[str, Any], fmt: LNSFormat, device):
    if set(node) >= {"packed", "scale"} and not isinstance(node["packed"],
                                                           dict):
        return LNSWeight(_tensor(node["packed"], device),
                         _tensor(node["scale"], device).to(torch.float32),
                         fmt)
    out = {k: (_build(v, fmt, device) if isinstance(v, dict)
               else _tensor(v, device)) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        # a pytree list (``prefix::0::...``): indices 0..n-1
        return [out[str(i)] for i in range(len(out))]
    return out


def params_from_flat(flat: Dict[str, np.ndarray], fmt: LNSFormat, *,
                     device=None) -> Dict[str, Any]:
    """Nested port params from ``::``-keyed arrays. ``fmt`` is the LNS
    format the packed words were written in (the layout stores no
    format)."""
    dev = resolve_device(device)
    prefix = "params" + SEP
    if any(k.startswith(prefix) for k in flat):
        flat = _subtree(flat, prefix)
    return _build(_nest(flat), fmt, dev)


def _subtree(flat, prefix: str):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _nest(flat) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def train_state_from_flat(flat: Dict[str, np.ndarray], mcfg, *,
                          device=None):
    """A port ``TrainState`` from a JAX train state's ``::``-keyed arrays:
    the packed words are read in ``mcfg.update_format``; the second
    moments (``opt::g2``, factored ``{r, c}`` dicts included), the step
    count and the step become f32 tensors and host ints."""
    from repro_torch.optim.madam import MadamState
    from repro_torch.training.steps import TrainState
    dev = resolve_device(device)
    params = params_from_flat(flat, mcfg.update_format, device=dev)
    g2 = _build(_nest(_subtree(flat, "opt" + SEP + "g2" + SEP)),
                mcfg.update_format, dev)
    opt = MadamState(g2=g2, count=int(flat["opt" + SEP + "count"]))
    return TrainState(params=params, opt=opt, step=int(flat["step"]))

