"""Async, atomic, keep-k checkpoints in the JAX package's on-disk layout.

Layout per step, as ``repro.checkpoint.CheckpointManager`` writes it::

    <dir>/step_00000042/
        manifest.json      # step, data cursor, sorted leaf keys, extra
        <leaf-key>.npy     # one file per leaf, keys joined with "::"
    <dir>/LATEST           # pointer to the newest step, written last

A packed weight is two leaves, ``<path>::packed`` and ``<path>::scale``;
a train state's leaves are ``params::…``, ``opt::g2::…``, ``opt::count``
and ``step``. Packed words wider than 8 bits are kept in int32 in the
port and written back as ``uint16`` (``uint32`` past 16 bits), the JAX
package's word dtype, so either framework restores what the other
wrote. Saving copies every leaf to the host before it returns; the files
are written on a thread, and the commit is a rename.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lns import LNSWeight, is_lns_weight

__all__ = ["CheckpointManager", "flatten_state"]

_SEP = "::"


def _items(node, path: Tuple[str, ...] = ()) -> Iterator:
    """``(path, leaf, fmt)`` over named tuples, dicts, packed weights,
    tensors and ints; ``fmt`` is the word format of a packed leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            yield from _items(getattr(node, f), path + (f,))
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _items(v, path + (str(k),))
    elif is_lns_weight(node):
        yield path + ("packed",), node.packed, node.fmt
        yield path + ("scale",), node.scale, None
        if node.delta is not None:
            yield path + ("delta",), node.delta, None
    else:
        yield path, node, None


def _to_numpy(leaf, fmt) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, dtype=np.int32)
    a = leaf.detach().cpu().numpy()
    if fmt is not None and fmt.bits > 8:
        a = a.astype(np.uint16 if fmt.bits <= 16 else np.uint32)
    return a


def flatten_state(state) -> Dict[str, np.ndarray]:
    """``::``-keyed numpy leaves of a state, as the JAX package keys
    them."""
    return {_SEP.join(p): _to_numpy(leaf, fmt)
            for p, leaf, fmt in _items(state)}


def _rebuild(like, path, load):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(getattr(like, f), path + (f,), load)
                            for f in like._fields])
    if isinstance(like, dict):
        return {k: _rebuild(v, path + (str(k),), load)
                for k, v in like.items()}
    if is_lns_weight(like):
        return LNSWeight(load(path + ("packed",), like.packed),
                         load(path + ("scale",), like.scale), like.fmt)
    return load(path, like)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, *, data_cursor: int = 0,
             extra: Optional[Dict[str, Any]] = None, async_: bool = True):
        """Snapshot ``state``: the host copy is taken before returning, so
        the caller may go on updating; the files are written in the
        background unless ``async_`` is false."""
        self.wait()
        flat = flatten_state(state)
        manifest = {"step": int(step), "data_cursor": int(data_cursor),
                    "keys": sorted(flat), "extra": extra or {},
                    "device_count": max(torch.cuda.device_count(), 1)}

        def write():
            try:
                final = os.path.join(self.dir, f"step_{step:08d}")
                tmp = final + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                for k, v in flat.items():
                    np.save(os.path.join(tmp, k.replace("/", "_") + ".npy"),
                            v, allow_pickle=False)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                shutil.rmtree(final, ignore_errors=True)
                os.rename(tmp, final)
                latest_tmp = os.path.join(self.dir, "LATEST.tmp")
                with open(latest_tmp, "w") as f:
                    f.write(os.path.basename(final))
                os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
                self._gc()
            except BaseException as e:  # raised again by the next wait()
                self._error = e

        if async_:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip().split("_")[-1])

    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, like):
        """A state shaped like ``like``, each leaf in ``like``'s dtype and
        on its device (ints stay ints)."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step:08d}")

        def load(path, leaf):
            arr = np.load(os.path.join(d, _SEP.join(path).replace("/", "_")
                                       + ".npy"))
            if not isinstance(leaf, torch.Tensor):
                return int(arr)
            if arr.dtype in (np.uint16, np.uint32):  # wide words: int32 (H2)
                arr = arr.astype(np.int64)
            t = torch.from_numpy(np.ascontiguousarray(arr))
            return t.to(device=leaf.device, dtype=leaf.dtype)

        return _rebuild(like, (), load)

    def restore_latest(self, like) -> Tuple[int, Any]:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return step, self.restore(step, like)
