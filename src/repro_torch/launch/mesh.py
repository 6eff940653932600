"""The serving mesh over ``torch.distributed``: one process per card.

``make_host_mesh(data, model)`` is the JAX package's function on the
port's process model. Launch one process a card with ``torchrun
--nproc-per-node N`` (``N = data * model``); each process calls it, which
starts the process group from torchrun's environment (NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU) and returns this rank's
:class:`Mesh`. A world of one (``data = model = 1``) starts without
torchrun, on an in-process store. Importing this module starts nothing.

Ranks are laid out row-major over ``(data, model)``: rank ``d * model +
j`` sits at data index ``d`` and model index ``j``; the ranks of one data
index form its ``model`` group, and the ranks of one model index its
``data`` group.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_host_mesh"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh:
    """This rank's view of a ``(data, model)`` mesh: ``axis_names`` and
    ``shape`` (what ``sharding.spec_for`` reads, as a JAX mesh has them),
    ``rank``, its ``coords`` on each axis, its ``device``, and the process
    group of each axis it belongs to (``group``). ``groups`` may be None
    for a mesh that only places leaves (no collectives)."""

    def __init__(self, shape: Dict[str, int], rank: int, device,
                 groups: Optional[Dict[str, object]] = None):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape = dict(shape)
        self.rank = rank
        self.device = torch.device(device)
        coords, r = {}, rank
        for a in reversed(self.axis_names):
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.coords = {a: coords[a] for a in self.axis_names}
        self._groups = groups or {}

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def group(self, axes):
        """The process group of ``axes`` (one axis name, or a tuple of
        them taken jointly) that holds this rank."""
        key = axes if isinstance(axes, str) else tuple(axes)
        if isinstance(key, tuple) and len(key) == 1:
            key = key[0]
        if key not in self._groups:
            raise ValueError(f"mesh has no process group for {key!r}")
        return self._groups[key]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


def _axis_ranks(shape: Sequence[int], axis: int):
    """Every group of ranks that differ only along ``axis`` (row-major)."""
    import itertools
    others = [range(n) for i, n in enumerate(shape) if i != axis]
    groups = []
    for rest in itertools.product(*others):
        ranks = []
        for j in range(shape[axis]):
            idx = list(rest)
            idx.insert(axis, j)
            r = 0
            for n, k in zip(shape, idx):
                r = r * n + k
            ranks.append(r)
        groups.append(ranks)
    return groups


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """This process's rank of a ``(data, model)`` mesh over the cards of
    one host (or CPU processes with ``device="cpu"``).

    Starts the default process group if none is running: from torchrun's
    environment, or for a world of one on an in-process store. Raises when
    ``data * model`` is not the world size, when a mesh of more than one
    rank has no torchrun environment, or when this rank's
    ``LOCAL_RANK`` names no visible card: a mesh that silently collapsed
    to fewer ranks would pass a parity check vacuously."""
    import torch.distributed as dist
    dev = resolve_device(device)
    n = data * model
    if n < 1:
        raise ValueError(f"make_host_mesh: bad mesh (data={data}, "
                         f"model={model})")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"make_host_mesh: LOCAL_RANK {local} but only "
                f"{torch.cuda.device_count()} cards are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if all(k in os.environ for k in _TORCHRUN_ENV):
            dist.init_process_group(backend, init_method="env://")
        elif n == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise ValueError(
                f"make_host_mesh: mesh (data={data}, model={model}) needs "
                f"{n} processes; start one a card with torchrun "
                f"--nproc-per-node {n} (no torchrun environment here)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"make_host_mesh: requested mesh (data={data}, model={model}) "
            f"needs {n} processes but the world has {world}; run "
            f"torchrun --nproc-per-node {n} or shrink the mesh")
    rank = dist.get_rank()
    groups: Dict[str, object] = {}
    # every rank makes every group, in one order (new_group is collective)
    for i, name in enumerate(("data", "model")):
        for ranks in _axis_ranks((data, model), i):
            g = dist.new_group(ranks) if n > 1 else dist.group.WORLD
            if rank in ranks:
                groups[name] = g
    groups[("data", "model")] = dist.group.WORLD
    return Mesh({"data": data, "model": model}, rank, dev, groups)
