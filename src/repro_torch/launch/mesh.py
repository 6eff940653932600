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

``make_production_mesh`` is the JAX package's function for H100 hosts:
``hosts`` hosts of ``cards`` cards, ``(data=hosts, model=cards)`` with
``model`` inside a host on NVLink, and an outer ``pod`` axis of 2 for
``multi_pod``. With ``device="meta"`` it is rank 0's mesh over torch's
fake process-group backend, which a dry run (``launch.dryrun``) traces
collectives through without a card or a peer.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh", "make_mesh"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh:
    """This rank's view of a ``(data, model)`` mesh: ``axis_names`` and
    ``shape`` (what ``sharding.spec_for`` reads, as a JAX mesh has them),
    ``rank``, its ``coords`` on each axis, its ``device``, and the process
    group of each axis it belongs to (``group``). ``groups`` may be None
    for a mesh that only places leaves (no collectives)."""

    def __init__(self, shape: Dict[str, int], rank: int, device,
                 groups: Optional[Dict[str, object]] = None,
                 cards_per_host: Optional[int] = None):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape = dict(shape)
        self.rank = rank
        self.device = torch.device(device)
        # consecutive ranks share a host, this many to a host (one host
        # holds the whole mesh by default)
        self.cards_per_host = cards_per_host or self.size
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

    def group_ranks(self, axes) -> Tuple[int, ...]:
        """The global ranks of this rank's group over ``axes`` (one axis
        name or a tuple of them), in group-rank order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        ranks = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords, **dict(zip(axes, idx)))
            r = 0
            for a in self.axis_names:
                r = r * self.shape[a] + c[a]
            ranks.append(r)
        return tuple(ranks)

    def within_host(self, axes) -> bool:
        """Whether this rank's group over ``axes`` lies inside one host
        (its links are NVLink, not the network)."""
        return len({r // self.cards_per_host
                    for r in self.group_ranks(axes)}) == 1

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """This process's rank of a ``(data, model)`` mesh over the cards of
    one host (or CPU processes with ``device="cpu"``).

    Starts the default process group if none is running: from torchrun's
    environment, or for a world of one on an in-process store. Raises when
    ``data * model`` is not the world size, when a mesh of more than one
    rank has no torchrun environment, or when this rank's
    ``LOCAL_RANK`` names no visible card: a mesh that silently collapsed
    to fewer ranks would pass a parity check vacuously."""
    if data < 1 or model < 1:
        raise ValueError(f"make_host_mesh: bad mesh (data={data}, "
                         f"model={model})")
    return make_mesh({"data": data, "model": model}, device,
                     what="make_host_mesh")


def make_production_mesh(*, multi_pod: bool = False, hosts: int = 32,
                         cards: int = 8, device=None) -> Mesh:
    """``(data=hosts, model=cards)``, with an outer ``pod`` axis of 2 for
    ``multi_pod``: 256 cards by default, 512 with ``multi_pod`` (the JAX
    package's counts). ``model`` spans the cards of a host (NVLink);
    ``data`` and ``pod`` span hosts.

    With ``device="meta"``, rank 0's mesh over the fake backend
    (``torch.testing._internal.distributed.fake_pg``): every axis group
    and every joint group is made, collectives run and move nothing. On
    cards it needs torchrun with the mesh's world size and raises
    otherwise; it never collapses to fewer ranks."""
    shape = {"data": hosts, "model": cards}
    if multi_pod:
        shape = {"pod": 2, **shape}
    return make_mesh(shape, device, cards_per_host=cards,
                     what="make_production_mesh")


def make_mesh(shape: Dict[str, int], device=None, *,
              cards_per_host: Optional[int] = None,
              what: str = "make_mesh") -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` (axis name -> size, the
    slowest first). On ``meta``: rank 0 of a fake world of that size (a
    running fake world of another size is replaced). Otherwise the
    default process group of torchrun's environment (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU), or an in-process store for a
    world of one; the world size must be the mesh's. Every rank makes
    every group (each axis's and each joint one), in one order."""
    import torch.distributed as dist
    dev = resolve_device(device)
    n = 1
    for v in shape.values():
        n *= v
    desc = ", ".join(f"{k}={v}" for k, v in shape.items())
    if n < 1:
        raise ValueError(f"{what}: bad mesh ({desc})")
    if dev.type == "meta":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if dist.is_initialized():
            if dist.get_backend() != "fake":
                raise ValueError(f"{what}: a {dist.get_backend()} process "
                                 f"group is running; a meta mesh needs the "
                                 f"fake backend")
            if dist.get_world_size() != n:
                dist.destroy_process_group()
        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=n)
    else:
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise ValueError(
                    f"{what}: LOCAL_RANK {local} but only "
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
                    f"{what}: mesh ({desc}) needs {n} processes; start one "
                    f"a card with torchrun --nproc-per-node {n} (no torchrun "
                    f"environment here)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"{what}: requested mesh ({desc}) needs {n} processes but the "
            f"world has {world}; run torchrun --nproc-per-node {n} or "
            f"shrink the mesh")
    from repro_torch.distributed import collectives
    rank = dist.get_rank()
    names = tuple(shape)
    dims = tuple(shape[a] for a in names)
    groups: Dict[object, object] = {}
    # each axis, then each joint set of axes (the whole mesh is the world)
    sets = [c for k in range(1, len(names) + 1)
            for c in itertools.combinations(range(len(names)), k)]
    for axes in sets:
        key = names[axes[0]] if len(axes) == 1 else tuple(
            names[i] for i in axes)
        if len(axes) == len(names) or n == 1:
            groups[key] = dist.group.WORLD
        else:
            for ranks in _axes_ranks(dims, axes):
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[key] = g
        collectives.name_group(groups[key], "+".join(
            (key,) if isinstance(key, str) else key))
    return Mesh(shape, rank, dev, groups, cards_per_host)


def _axes_ranks(shape: Sequence[int], axes: Tuple[int, ...]):
    """Every group of ranks that differ only along ``axes`` (row-major),
    each in group-rank order (``axes`` jointly, the first the slowest)."""
    others = [i for i in range(len(shape)) if i not in axes]
    groups = []
    for rest in itertools.product(*(range(shape[i]) for i in others)):
        ranks = []
        for idx in itertools.product(*(range(shape[i]) for i in axes)):
            c = dict(zip(others, rest))
            c.update(zip(axes, idx))
            r = 0
            for i, size in enumerate(shape):
                r = r * size + c[i]
            ranks.append(r)
        groups.append(ranks)
    return groups
