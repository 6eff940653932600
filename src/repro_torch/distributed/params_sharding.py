"""Logical axes of the parameter, optimizer and cache trees, and a rank's
local slice of them (``repro.distributed.params_sharding``'s tables).

Each leaf is mapped by its tree path to a tuple of logical axis names,
which ``sharding.spec_for`` resolves against a mesh and rules into a
placement. Stacked ``period`` leaves get a leading ``"stack"`` axis; a
packed :class:`LNSWeight` shards its words like the dense weight and its
scale the same way, with every size-1 scale axis unsharded.

The port holds each rank's shard as a plain tensor: :func:`shard_tree`
slices a full tree (a carried JAX tree from ``repro_torch.convert``, or a
drawn one) into rank r's local tree, and :class:`LocalShard` does the same
a leaf at a time while ``models.model.init_params`` draws, so no rank
ever holds more than one full leaf.

One rule is the port's own: zamba2's shared attention ``wq``/``wk``/
``wv`` and every occurrence's ``lora_a``/``lora_b`` stay whole on every
rank, whatever their logical axes (the tables keep JAX's, whose
``("lora", "qkv_out")`` for ``lora_b`` is a GSPMD placement that changes
no value). A contiguous ``qkv_out`` slice of ``lora_b``'s fused ``[q | k
| v]`` columns is not a rank's head group, and the LoRA-merged QKV takes
``qeinsum``'s dense leg, whose cuBLAS GEMM sums a column block in
another order than the whole call at decode shapes (``chip_smoke.py``
phase 27c). So every rank merges and projects at the whole width, as one
card does, and keeps its heads' columns of q, k and v
(``models.attention.attn_apply``); the KV pools still hold the rank's
head group. :func:`split_axes` gives the placement the port really
keeps.

Which table a placement takes follows its rules
(:func:`serving_placement`): under ``sharding.train_rules``, JAX's
training placement, every leaf takes JAX's non-serving axes (``wo`` and
``down`` split by rows, ``tok`` by vocabulary rows, an untied ``head`` by
vocabulary columns, where the rules split those dims), and the port's
kept-whole rule above does not apply (the families it concerns do not
train tensor-parallel); under every other table the serving overrides
apply.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.lns import LNSWeight, is_lns_weight
from repro_torch.distributed.sharding import current_rules, spec_for

__all__ = ["params_logical_axes", "cache_logical_axes", "opt_logical_axes",
           "batch_shardings", "batch_rows", "tree_shardings",
           "local_shape", "shard_leaf", "shard_tree", "LocalShard",
           "kept_whole", "serving_placement", "split_axes", "cache_leaf_axes",
           "cache_local_shape",
           "RING_AXES", "STATE_KINDS"]

# leaf name -> logical axes of the 2-D core (the JAX package's table)
_BY_NAME: Dict[str, Tuple[Optional[str], ...]] = {
    "tok": ("vocab", "embed"),
    "head": ("embed", "vocab"),
    "wq": ("embed", "qkv_out"),
    "wk": ("embed", "qkv_out"),
    "wv": ("embed", "qkv_out"),
    "wo": ("qkv_out", "embed"),
    "bq": ("qkv_out",),
    "bk": ("qkv_out",),
    "bv": ("qkv_out",),
    "q_down": ("embed", None),
    "q_up": (None, "qkv_out"),
    "kv_down": ("embed", None),
    "kv_up": (None, "qkv_out"),
    "up": ("embed", "mlp"),
    "gate": ("embed", "mlp"),
    "down": ("mlp", "embed"),
    "router": ("embed", None),
    "w_up": ("experts", "embed", "moe_ff"),
    "w_gate": ("experts", "embed", "moe_ff"),
    "w_down": ("experts", "moe_ff", "embed"),
    "z_proj": ("embed", "ssm_inner"),
    "x_proj": ("embed", "ssm_inner"),
    "b_proj": ("embed", None),
    "c_proj": ("embed", None),
    "dt_proj": ("embed", None),
    "out_proj": ("ssm_inner", "embed"),
    "conv_wx": (None, "ssm_inner"),
    "norm": ("ssm_inner",),
    "wr": ("embed", "ssm_inner"),
    "wg": ("embed", "ssm_inner"),
    "ck": ("embed", "mlp"),
    "cv": ("mlp", "embed"),
    "cr": ("embed", None),
    "lora_a": ("embed", "lora"),
    "lora_b": ("lora", "qkv_out"),
    "proj": (None, "embed"),        # the MTP combiner
}

# rwkv's names that collide with attention's
_RWKV_NAMES = {
    "wk": ("embed", "ssm_inner"),
    "wv": ("embed", "ssm_inner"),
    "wo": ("ssm_inner", "embed"),
}

# the serving forward's overrides: the second GEMM of each column-parallel
# pair keeps its contraction dim replicated, so no contraction is split
# over ranks (a cross-rank sum reorders the accumulation; the activation
# is all-gathered before it instead)
_SERVING_NAMES = {
    "wo": (None, "embed"),
    "down": (None, "embed"),
    "out_proj": (None, "embed"),
    "cv": (None, "embed"),
}

# decode-cache leaves by name: k/v carry "kv_seq" and "kv_heads"; the
# default rules map both to "model" and first-wins keeps the split-KV
# layout, the serving rules set kv_seq -> None and shard the heads
_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "k_scale": ("batch", "kv_seq", "kv_heads", None),
    "v_scale": ("batch", "kv_seq", "kv_heads", None),
    "kp": (None, None, "kv_heads", None),
    "vp": (None, None, "kv_heads", None),
    "kp_scale": (None, None, "kv_heads", None),
    "vp_scale": (None, None, "kv_heads", None),
    "c_kv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "ssm": ("batch", "act_heads", None, None),
    "S": ("batch", "act_heads", None, None),
    "conv_x": ("batch", None, "ssm_inner"),
    "conv_b": ("batch", None, None),
    "conv_c": ("batch", None, None),
    "shift_tm": ("batch", None),
    "shift_cm": ("batch", None),
    "idx": ("batch",),
}

# the port's own placement of the cache leaves that JAX's table would
# split by position: a sliding-window ring (at most ``sliding_window +
# slack`` slots a layer) keeps every slot, which are not positions in
# order, and the KV heads as the serving placement shards them; the
# recurrent state of a ``mamba`` or ``rwkv`` layer keeps every head and
# channel (the serving rules keep ``ssm_inner`` whole) and splits its rows
# only. Neither changes a value; split-KV decode splits the dense KV and
# MLA latent caches, the leaves that grow with the context
RING_AXES = ("batch", None, "kv_heads", None)
STATE_KINDS = ("mamba", "rwkv")


def serving_placement(rules=None) -> bool:
    """Whether a placement under ``rules`` (overrides over the active
    ones) takes the serving overrides: unless the rules split the input
    of a row-parallel GEMM (the heads' output entering ``wo``, the MLP's
    hidden state entering ``down``), as JAX's training placement does
    (``sharding.train_rules``, the JAX package's default rules)."""
    rules = {**current_rules(), **(rules or {})}
    return not (rules.get("attn_out") or rules.get("act_ff"))


def kept_whole(path) -> bool:
    """The port's rule (module docstring): a leaf every rank holds whole
    under serving whatever its logical axes, zamba2's shared QKV and its
    LoRA leaves. ``path`` is a tree path."""
    names = _names(path)
    if not names:
        return False
    if names[-1] in ("lora_a", "lora_b"):
        return True
    return names[:2] == ("shared", "attn") and names[-1] in ("wq", "wk",
                                                             "wv")


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _names(path) -> Tuple[str, ...]:
    """A port tree path as JAX's key names (a list index is ``[i]``)."""
    return tuple(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


def _leaf_axes(names: Tuple[str, ...], ndim: int,
               serving: bool = False) -> Tuple[Optional[str], ...]:
    name = names[-1] if names else ""
    table = dict(_BY_NAME)
    if "rwkv" in names:
        table.update(_RWKV_NAMES)
    if serving:
        table.update(_SERVING_NAMES)
    axes = table.get(name)
    if axes is None:
        axes = (None,) * ndim        # norms, scalars, unknown: replicated
    if ndim > len(axes):             # stacked (scanned) leading axes
        axes = ("stack",) * (ndim - len(axes)) + tuple(axes)
    elif ndim < len(axes):
        axes = tuple(axes[-ndim:]) if ndim else ()
    return tuple(axes)


def _lns_axes(names, leaf: LNSWeight, serving: bool) -> LNSWeight:
    axes = _leaf_axes(names, leaf.packed.dim(), serving)
    if leaf.scale.dim() == leaf.packed.dim():
        scale_axes = tuple(a if leaf.scale.shape[i] != 1 else None
                           for i, a in enumerate(axes))
    else:
        scale_axes = (None,) * leaf.scale.dim()
    return LNSWeight(packed=axes, scale=scale_axes, fmt=leaf.fmt)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def params_logical_axes(params, serving: bool = False) -> Any:
    """The tree of logical-axes tuples matching ``params``; a packed leaf
    maps to an ``LNSWeight`` whose ``packed`` and ``scale`` are its words'
    and its scale's axes. ``serving`` applies the serving overrides."""
    def visit(path, leaf):
        names = _names(path)
        if is_lns_weight(leaf):
            return _lns_axes(names, leaf, serving)
        return _leaf_axes(names, leaf.dim(), serving)
    return _map(params, visit)


def opt_logical_axes(params, opt_state):
    """A ``MadamState`` of axes: ``g2`` mirrors each weight's words
    (a factored ``{r, c}`` leaf takes the row and column marginals of the
    words' axes); ``count`` is replicated."""
    p_axes = params_logical_axes(params)

    def walk(axes, g2):
        if isinstance(axes, LNSWeight) or _is_axes(axes):
            code = axes.packed if isinstance(axes, LNSWeight) else axes
            if isinstance(g2, dict):
                return {"r": tuple(code[:-1]),
                        "c": tuple(code[:-2]) + tuple(code[-1:])}
            return tuple(code)
        if isinstance(axes, dict):
            return {k: walk(axes[k], g2[k]) for k in axes}
        return [walk(a, g) for a, g in zip(axes, g2)]

    return type(opt_state)(g2=walk(p_axes, opt_state.g2), count=())


def cache_leaf_axes(name: str, ndim: int,
                    kind: Optional[str] = None) -> Tuple[Optional[str], ...]:
    """The logical axes of one decode-cache leaf ``name`` with ``ndim``
    dims (a stacked period leaf has a leading ``"stack"``): JAX's table,
    or with the layer's ``kind`` the placement the port keeps (a
    ``local`` layer's ring and a recurrent layer's state, above)."""
    axes = _CACHE_AXES.get(name, (None,) * ndim)
    if kind == "local" and name in ("k", "v", "k_scale", "v_scale"):
        axes = RING_AXES
    elif kind in STATE_KINDS:
        axes = ("batch",) + (None,) * (len(axes) - 1)
    if ndim > len(axes):
        axes = ("stack",) * (ndim - len(axes)) + tuple(axes)
    return tuple(axes)


def _layer_kind(path, cfg) -> Optional[str]:
    """The layer kind of a cache path (``("prefix", i, leaf)`` or
    ``("period", "pos<j>", leaf)``) under ``cfg.layer_pattern()``."""
    prefix, _, period = cfg.layer_pattern()
    if path[0] == "prefix":
        return prefix[path[1]]
    return period[int(str(path[1])[3:])]


def cache_logical_axes(caches, cfg=None) -> Any:
    """The tree of logical-axes tuples matching a decode-cache tree: JAX's
    table, or with ``cfg`` (whose ``layer_pattern`` names each layer's
    kind) the placement the port keeps (:func:`cache_leaf_axes`)."""
    def visit(path, leaf):
        kind = None if cfg is None else _layer_kind(path, cfg)
        return cache_leaf_axes(str(path[-1]), leaf.dim(), kind)
    return _map(caches, visit)


def cache_local_shape(shape: Sequence[int], name: str,
                      kind: Optional[str] = None, mesh=None,
                      rules=None) -> Tuple[int, ...]:
    """A rank's shard shape of the cache leaf ``name`` of a ``kind``
    layer, whole ``shape`` given (without its stack axis), under the
    active mesh and rules: dense KV caches and MLA latents split by
    position where ``kv_seq`` resolves (first-wins: the earlier
    ``kv_seq`` dim takes ``model`` from the KV heads, as JAX's
    ``spec_for``), rows where ``batch`` does. ``shape`` itself without a
    mesh."""
    from repro_torch.distributed.sharding import current_mesh
    mesh = mesh or current_mesh()
    if mesh is None:
        return tuple(shape)
    spec = spec_for(cache_leaf_axes(name, len(shape), kind), mesh, rules)
    return local_shape(shape, spec, mesh)


def tree_shardings(axes_tree, mesh, rules=None):
    """Resolve a logical-axes tree into placements (``spec_for`` tuples);
    a packed leaf's entry is an ``LNSWeight`` of its words' and scale's
    placements."""
    def one(axes):
        if isinstance(axes, LNSWeight):
            return LNSWeight(packed=spec_for(axes.packed, mesh, rules),
                             scale=spec_for(axes.scale, mesh, rules),
                             fmt=axes.fmt)
        return spec_for(axes, mesh, rules)

    def walk(t):
        if isinstance(t, LNSWeight) or _is_axes(t):
            return one(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if hasattr(t, "_fields"):          # a NamedTuple (MadamState)
            return type(t)(*(walk(v) for v in t))
        return t
    return walk(axes_tree)


def batch_shardings(batch: Dict[str, Any], mesh, rules=None):
    """Batch tensors shard over ``("pod", "data")`` on the batch axis."""
    return {k: spec_for(("batch",) + (None,) * (v.ndim - 1), mesh, rules)
            for k, v in batch.items()}


def batch_rows(batch: Dict[str, torch.Tensor], mesh,
               rules=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: each tensor sliced along its
    leading dim by its :func:`batch_shardings` placement (the rank's data
    shard, shards in rank order), as JAX's ``device_put`` with those
    shardings leaves on each device. The leading dim must split evenly."""
    places = batch_shardings(batch, mesh, rules)
    return {k: _slice(v, places[k], mesh) for k, v in batch.items()}


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split(mesh, entry) -> Tuple[int, int]:
    """(shards, this rank's index) of a dim placed on ``entry``: the mesh
    axes taken jointly, the first the slowest."""
    n, idx = 1, 0
    for a in _entry_axes(entry):
        n *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return n, idx


def local_shape(shape: Sequence[int], spec: tuple, mesh) -> Tuple[int, ...]:
    """A rank's shard shape of a tensor of ``shape`` placed by ``spec``."""
    out = []
    for i, size in enumerate(shape):
        n, _ = _split(mesh, spec[i] if i < len(spec) else None)
        if size % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"into {n} shards ({spec})")
        out.append(size // n)
    return tuple(out)


def _slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    out = t
    sliced = False
    for i in range(t.dim()):
        n, idx = _split(mesh, spec[i] if i < len(spec) else None)
        if n == 1:
            continue
        if t.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(t.shape)} does not split "
                             f"into {n} shards ({spec})")
        size = t.shape[i] // n
        out = out.narrow(i, idx * size, size)
        sliced = True
    # a copy, so the full leaf's storage can go
    return out.clone(memory_format=torch.contiguous_format) if sliced else t


def shard_leaf(leaf, placement, mesh):
    """This rank's shard of one leaf under its placement (an
    ``LNSWeight`` of placements for a packed leaf)."""
    if is_lns_weight(leaf):
        return LNSWeight(_slice(leaf.packed, placement.packed, mesh),
                         _slice(leaf.scale, placement.scale, mesh), leaf.fmt)
    return _slice(leaf, placement, mesh)


def shard_tree(tree, mesh, rules=None, *, caches: bool = False, cfg=None):
    """Rank ``mesh.rank``'s local tree of a full parameter tree (or, with
    ``caches``, a decode-cache tree, placed as the port keeps it where
    ``cfg`` names the layer kinds: :func:`cache_logical_axes`): every
    leaf sliced by its placement under ``mesh`` and ``rules``. The
    serving overrides apply unless the rules are JAX's training
    placement (:func:`serving_placement`); ``convert.params_from_flat``
    output goes in, the rank's shard comes out."""
    serving = serving_placement(rules)
    axes = (cache_logical_axes(tree, cfg) if caches
            else params_logical_axes(tree, serving=serving))
    places = tree_shardings(axes, mesh, rules)

    def walk(t, p, path):
        if isinstance(t, dict):
            return {k: walk(v, p[k], path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, q, path + (i,))
                    for i, (v, q) in enumerate(zip(t, p))]
        if serving and not caches and kept_whole(path):
            return t
        return shard_leaf(t, p, mesh)
    return walk(tree, places, ())


def split_axes(params, mesh, rules=None) -> Any:
    """The tree of the mesh axes (of size > 1, in the mesh's order) each
    leaf is split over as the port places it under ``rules``
    (:func:`shard_tree`'s placement; ``()`` for a leaf every rank holds
    whole): what a sum over a leaf's shards reduces over to be the whole
    leaf's. Reads names and ranks only, so a rank's local tree gives the
    same answer as the full one."""
    serving = serving_placement(rules)
    axes = params_logical_axes(params, serving=serving)
    places = tree_shardings(axes, mesh, rules)

    def walk(t, p, path):
        if isinstance(t, dict):
            return {k: walk(v, p[k], path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, q, path + (i,))
                    for i, (v, q) in enumerate(zip(t, p))]
        if serving and kept_whole(path):
            return ()
        spec = p.packed if isinstance(p, LNSWeight) else p
        used = set()
        for entry in spec:
            used.update(_entry_axes(entry))
        return tuple(a for a in mesh.axis_names
                     if a in used and mesh.shape[a] > 1)
    return walk(params, places, ())


class LocalShard:
    """The rank's shard of each leaf as ``models.model.init_params``
    draws it (``init_params(shard=LocalShard(...))``): a drawn leaf (after
    its ``leaf_fn``) is sliced at once (a :func:`kept_whole` leaf stays
    whole), and an expert stack is drawn whole but encoded only over the
    rank's experts (:meth:`experts`). The placement is
    :func:`shard_tree`'s under ``rules``."""

    def __init__(self, mesh, rules=None):
        self.mesh, self.rules = mesh, rules
        self.serving = serving_placement(rules)

    def _spec(self, path, leaf):
        names = _names(path)
        if is_lns_weight(leaf):
            return tree_shardings(_lns_axes(names, leaf, self.serving),
                                  self.mesh, self.rules)
        return spec_for(_leaf_axes(names, leaf.dim(), self.serving),
                        self.mesh, self.rules)

    def __call__(self, path, leaf):
        if self.serving and kept_whole(path):
            return leaf
        return shard_leaf(leaf, self._spec(path, leaf), self.mesh)

    def experts(self, path, ndim: int, E: int) -> Tuple[int, int]:
        """``[lo, hi)``: the rank's experts of a stack of ``E`` at
        ``path`` with ``ndim`` dims (the layer axis included)."""
        axes = _leaf_axes(_names(path), ndim, self.serving)
        spec = spec_for(axes, self.mesh, self.rules)
        n, idx = _split(self.mesh, spec[ndim - 3])
        if E % n:
            raise ValueError(f"{E} experts do not split into {n} shards")
        return idx * (E // n), (idx + 1) * (E // n)
