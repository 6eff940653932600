"""A step's cost as the port runs it: one ``TorchDispatchMode`` that
totals what a step does, op by op, on the ``cpu``, ``cuda`` or ``meta``
device alike, so a dry run on ``meta`` can be held against a real run of
the same step.

* **FLOPs**: every aten op that ``torch.utils.flop_counter``'s registry
  prices (the matmuls, convolutions and attentions), plus each kernel's
  operations as ``kernels.costs`` counts them.
* **Bytes**: of every aten op that is not a view, its inputs' and its
  outputs' bytes, plus each kernel's bytes. This is the traffic of the
  program as the port launches it, one op after another, unfused: no
  op's output is taken to stay in a cache for the next.
* **Peak live bytes**: the step's arguments, plus the largest total of
  the storages made since the step began that were alive at once
  (each tracked with ``weakref.finalize`` until it is freed).
* **Argument and output bytes**: the unique storages of the step's
  arguments and of its outputs; outputs that are arguments (a cache
  written in place) are aliases.

A kernel's own aten ops (its plain version on the CPU, its wrapper's
allocations on the card) are not counted: the dispatch layer charges the
kernel's cost instead and hands its outputs over as new storage, so one
kernel call costs the same on every device. Collectives are counted by
``distributed.collectives`` (their bytes by kind and mesh axis), not
here. The same ops run on the same shapes on every device, so FLOPs,
bytes and arguments agree exactly; the peak leaves out what a kernel
holds while it runs and what the allocator rounds up.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import costs

__all__ = ["CostMode", "tensor_bytes"]

_aten = torch.ops.aten
# ops that write nothing (allocations) or only alias their input
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view}


def _tensors(tree, out=None):
    """The tensors of an op's arguments or results (tuples, lists and
    dicts of them), in order; faster than a pytree walk, which the mode
    would otherwise pay on every op."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _storages(tree) -> Dict[int, int]:
    """The unique storages of the tensors in a port tree: id -> bytes."""
    out: Dict[int, int] = {}
    for t in _flatten(tree):
        s = t.untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


def tensor_bytes(tree) -> int:
    """The bytes of the unique storages of the tensors in ``tree``
    (nested dicts, lists, tuples, NamedTuples and ``LNSWeight``)."""
    return sum(_storages(tree).values())


def _flatten(tree):
    """Tensors of a port tree (``LNSWeight`` is a NamedTuple-like
    carrier pytree does not know)."""
    from repro_torch.core.lns import is_lns_weight
    if isinstance(tree, torch.Tensor):
        return [tree]
    if is_lns_weight(tree):
        return [tree.packed, tree.scale]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return []


class CostMode(TorchDispatchMode):
    """Totals of the ops run within the mode (``with CostMode(args):``).
    ``args`` are the step's arguments: their storages are the argument
    bytes and are not new. After the block, :meth:`outputs` takes the
    step's result and :meth:`report` gives the totals. The mode is also
    the kernels' cost sink (``kernels.costs``): ``charge`` takes each
    kernel call's cost, ``kernels`` holds them by kernel."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.aten_flops = 0
        self.aten_bytes = 0
        self.ops = 0
        self.kernels: Dict[str, list] = {}
        self.inside = 0
        self._args = _storages(args)
        self._live: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._sink_ctx = None

    # ---- the kernels' sink --------------------------------------------
    def charge(self, name: str, cost: "costs.Cost") -> None:
        costs.add(self.kernels, name, cost)

    def kernel_outputs(self, out) -> None:
        self._track(out)

    # ---- the mode ----------------------------------------------------
    def __enter__(self):
        self._sink_ctx = costs.sink(self)
        self._sink_ctx.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink_ctx.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.inside or func.namespace != "aten":
            return out
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.aten_flops += flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        if not func.is_view and packet not in _NO_BYTES:
            self.aten_bytes += sum(t.nbytes for t in
                                   _tensors(out, _tensors((args, kwargs))))
        self._track(out)
        return out

    def _track(self, out) -> None:
        for t in _tensors(out):
            s = t.untyped_storage()
            key = s._cdata
            if key in self._live or key in self._args:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live += n
            weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self.live -= n

    # ---- results -----------------------------------------------------
    def outputs(self, result) -> None:
        """The step's result: its storages' bytes (the output bytes), of
        which those that are arguments' (the alias bytes)."""
        seen = _storages(result)
        self.output_bytes = sum(seen.values())
        self.alias_bytes = sum(n for k, n in seen.items() if k in self._args)

    def report(self) -> Dict[str, Any]:
        """``flops``, ``bytes``, the kernels' share of each, the memory
        keys of a dry-run row (``argument_size_in_bytes``,
        ``output_size_in_bytes``, ``alias_size_in_bytes``,
        ``temp_size_in_bytes``, ``peak_bytes``) and the calls, operations
        and bytes of each kernel."""
        kern = self.kernels
        k_ops = sum(r[1] for r in kern.values())
        k_bytes = sum(r[2] + r[3] for r in kern.values())
        arg = sum(self._args.values())
        new_out = self.output_bytes - self.alias_bytes
        return {
            "flops": float(self.aten_flops + k_ops),
            "bytes": float(self.aten_bytes + k_bytes),
            "kernel_flops": float(k_ops),
            "kernel_bytes": float(k_bytes),
            "aten_ops": self.ops,
            "memory": {
                "argument_size_in_bytes": float(arg),
                "output_size_in_bytes": float(self.output_bytes),
                "alias_size_in_bytes": float(self.alias_bytes),
                "temp_size_in_bytes": float(max(self.peak - new_out, 0)),
                "peak_bytes": float(arg + self.peak),
            },
            "kernels": {k: {"calls": r[0], "ops": r[1], "read": r[2],
                            "written": r[3]} for k, r in kern.items()},
        }
