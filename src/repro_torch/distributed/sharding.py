"""Logical-axis sharding rules (``repro.distributed.sharding``'s tables).

Model code names the axes of a tensor with *logical* names (``"embed"``,
``"qkv_out"``, ``"experts"``...); a rules table maps each logical name to
mesh axes. The tables, the first-wins resolution and the serving overrides
are the JAX package's, so a placement here is the one JAX's
``spec_for`` gives for the same names, rules and mesh.

The JAX package is one controller over many devices and GSPMD inserts the
collectives its constraints imply. The port runs one process per card:
each rank holds its own shard of a leaf as a plain tensor, and the model
code issues the collectives itself, at the points the serving rules
allow (``repro_torch.distributed.collectives``). So a placement here is
data, a tuple of mesh-axis entries per tensor dim, used to slice a full
leaf into a rank's local one (``params_sharding.shard_tree``) and to ask
which process group a logical axis spans (:func:`axis_group`). Nothing
redistributes a tensor in the forward.

A mesh is any object with ``axis_names`` (a tuple of str) and ``shape``
(a dict name -> size); ``repro_torch.launch.mesh.Mesh`` adds the rank's
coordinates and the process group of each axis.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

__all__ = ["LOGICAL_RULES", "shard_ctx", "current_mesh", "current_rules",
           "spec_for", "serving_rules", "data_rules", "train_rules",
           "decode_rules", "batch_divisor",
           "model_axis_size", "axis_group",
           "axis_shards", "axis_index", "joint_group", "batch_group"]

AxisVal = Union[None, str, Tuple[str, ...]]

# Default logical -> mesh rules, the JAX package's. Tuples shard over
# those axes jointly; axes missing from the active mesh are dropped at
# resolve time, so one table serves (data, model) and (pod, data, model).
LOGICAL_RULES: Dict[str, AxisVal] = {
    # activations
    "batch": ("pod", "data"),
    "batch_full": ("pod", "data", "model"),
    "seq": None,
    "seq_shard": "model",
    "kv_seq": "model",
    "attn_out": "model",
    "embed": None,
    "act_ff": "model",
    "act_heads": "model",
    # weights
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv_out": "model",
    "ff_fsdp": "data",
    "experts": "model",
    "moe_ff": None,
    "lora": None,
    "ssm_inner": "model",
    "stack": None,
    "replicated": None,
}

_ctx = threading.local()


def current_mesh():
    return getattr(_ctx, "mesh", None)


def current_rules() -> Dict[str, AxisVal]:
    return getattr(_ctx, "rules", LOGICAL_RULES)


@contextlib.contextmanager
def shard_ctx(mesh, overrides: Optional[Dict[str, AxisVal]] = None):
    """Activate a mesh and rule overrides for the model code in scope
    (a thread-local, as in the JAX package: the gateway's driver steps
    the engine on its own thread, so the engine enters it per call)."""
    prev_mesh = getattr(_ctx, "mesh", None)
    prev_rules = getattr(_ctx, "rules", LOGICAL_RULES)
    _ctx.mesh = mesh
    rules = dict(LOGICAL_RULES)
    if overrides:
        rules.update(overrides)
    _ctx.rules = rules
    try:
        yield
    finally:
        _ctx.mesh = prev_mesh
        _ctx.rules = prev_rules


def _resolve(name: Optional[str], mesh, rules: Dict[str, AxisVal]):
    if name is None:
        return None
    if name not in rules:
        raise KeyError(f"unknown logical axis {name!r}")
    val = rules[name]
    if val is None:
        return None
    axes = (val,) if isinstance(val, str) else tuple(val)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def model_axis_size(mesh=None) -> int:
    """Size of the ``model`` mesh axis (1 without a mesh or the axis)."""
    mesh = mesh or current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def serving_rules(cfg, mesh=None) -> Dict[str, AxisVal]:
    """The JAX package's overrides for the mesh serving forward, which must
    give the single device's tokens: activations, embedding and head
    replicated; a column-parallel weight sharded over ``model`` only where
    its dimension divides the axis (heads where both head counts divide,
    the MLP where ``d_ff`` does, experts where their count does); the
    second GEMM of each pair contracts over a replicated dim, so no sum
    is ever split across ranks. ``cfg`` is duck-typed."""
    m = model_axis_size(mesh)
    heads_ok = m > 1 and getattr(cfg, "num_heads", 0) % m == 0
    kv_ok = heads_ok and getattr(cfg, "num_kv_heads", 0) % m == 0
    mlp_ok = m > 1 and getattr(cfg, "d_ff", 0) % m == 0
    moe_ok = m > 1 and getattr(cfg, "num_experts", 0) % m == 0
    on = lambda ok: "model" if ok else None
    return {
        "batch": None, "batch_full": None, "seq": None, "seq_shard": None,
        "kv_seq": None, "act_ff": None, "attn_out": None, "vocab": None,
        "ff_fsdp": None, "ssm_inner": None, "moe_ff": None,
        "heads": on(heads_ok),
        "act_heads": on(kv_ok),
        "kv_heads": on(kv_ok),
        "qkv_out": on(kv_ok),
        "mlp": on(mlp_ok),
        "experts": on(moe_ok),
    }


def batch_divisor(mesh) -> int:
    """The product of the mesh's ``pod`` and ``data`` sizes: what a global
    batch must split into for ``batch`` to shard over them (JAX's
    ``_mesh_batch_div``)."""
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def data_rules(cfg, mesh=None,
               global_batch: Optional[int] = None) -> Dict[str, AxisVal]:
    """Rows over data, weights on :func:`serving_rules`: the placement of
    the port's prefill (``training.steps.build_prefill_step(mesh=)``) and
    of its column-parallel train step, whose forward this is. The rows of
    the global batch split over ``("pod", "data")`` (JAX's
    :data:`LOGICAL_RULES` ``batch``; smollm-135m's own rule adds
    ``model``, which its column-parallel MLP cannot take: every rank of a
    model group must hold the same rows), and every other name is
    :func:`serving_rules`'s. ``global_batch``, where given, must split
    over the data axes, or this raises.

    Where this differs from JAX's GSPMD training placement: JAX shards the
    second GEMM of each column-parallel pair (``wo``, ``down``) row-
    parallel, sums the halves over ``model`` and splits the embedding,
    the head and the logits by vocabulary; here that GEMM is replicated
    and its input all-gathered, so the forward splits no sum and a rank's
    rows give the single device's values. :func:`train_rules` is JAX's
    placement."""
    out = serving_rules(cfg, mesh)
    out["batch"] = LOGICAL_RULES["batch"]
    mesh = mesh or current_mesh()
    if (mesh is not None and global_batch is not None
            and global_batch % batch_divisor(mesh)):
        axes = [a for a in ("pod", "data") if a in mesh.axis_names]
        raise ValueError(
            f"a global batch of {global_batch} does not split over the "
            f"data axes {'+'.join(axes)} ({batch_divisor(mesh)} ranks)")
    return out


def train_rules(cfg, mesh=None,
                global_batch: Optional[int] = None) -> Dict[str, AxisVal]:
    """JAX's training placement for the dense family (its default
    :data:`LOGICAL_RULES` with the leaves' non-serving axes,
    ``params_sharding.params_logical_axes(serving=False)``): the rows and
    the column-parallel weights as in :func:`data_rules` (which raises on
    a ``global_batch`` that does not split), and the second GEMM of each
    pair row-parallel: ``attn_out`` over ``model`` where ``qkv_out`` is
    split (``wo`` holds the rank's rows, the heads' output is not
    gathered), ``act_ff`` where ``mlp`` is (``down`` likewise), and
    ``vocab`` where ``cfg.vocab_size`` divides the axis (the embedding
    table's rows, an untied head's columns and the logits split by
    vocabulary). Each row block's partial product is SUM-reduced over the
    model group in f32 and rounded once (``collectives.sum_forward``), so
    the forward reorders the one device's contraction in f32.

    Two ways this differs from JAX: where a dim does not divide the
    ``model`` axis the port keeps it whole, as :func:`serving_rules` does,
    where GSPMD pads it; and heads that do not divide the axis stay whole
    on every rank, where JAX's rules would run that attention sequence-
    parallel (``seq_shard``; not ported, ROADMAP 7l). An architecture's
    own rules are not merged (smollm-135m's rows over ``model`` are
    refused as under :func:`data_rules`)."""
    out = data_rules(cfg, mesh, global_batch)
    m = model_axis_size(mesh)
    if out["qkv_out"]:
        out["attn_out"] = "model"
    if out["mlp"]:
        out["act_ff"] = "model"
    if m > 1 and getattr(cfg, "vocab_size", 0) % m == 0:
        out["vocab"] = "model"
    return out


def decode_rules(cfg, mesh=None, global_batch: Optional[int] = None,
                 arch_rules: Optional[Dict[str, AxisVal]] = None
                 ) -> Dict[str, AxisVal]:
    """The split-KV decode placement: JAX's dry run decodes under
    ``get_rules(arch)`` over :data:`LOGICAL_RULES`, so its rows split over
    ``("pod", "data")`` (:func:`data_rules`) and every dense KV and MLA
    latent cache (``("batch", "kv_seq", "kv_heads", None)``) splits by
    position over ``model``, which first-wins takes from the KV heads.
    ``kv_seq`` is the config's own rule where ``arch_rules`` names one
    (smollm-135m's ``None`` keeps its caches whole by position). Where
    ``global_batch`` does not split over the data axes (long_500k's batch
    of 1), the rows are replicated and the positions spread over
    ``("data", "model")``, JAX's override (``repro.launch.dryrun``).

    The weights keep :func:`data_rules`' serving placement, and so do the
    caches' KV heads where ``kv_seq`` leaves them the axis, so the forward
    splits no sum (the one place this differs from JAX's GSPMD decode)."""
    mesh = mesh or current_mesh()
    whole = (mesh is not None and global_batch is not None
             and global_batch % batch_divisor(mesh))
    out = data_rules(cfg, mesh)
    base = {**LOGICAL_RULES, **(arch_rules or {})}
    out["kv_seq"] = base["kv_seq"]
    if whole:
        out["batch"], out["kv_seq"] = None, ("data", "model")
    return out


def spec_for(names: Sequence[Optional[str]], mesh=None,
             rules: Optional[Dict[str, AxisVal]] = None) -> tuple:
    """The placement of a tensor whose dims carry the logical ``names``:
    a tuple with one entry a dim, ``None``, a mesh-axis name or a tuple of
    them (JAX's ``PartitionSpec`` entries; ``()`` without a mesh).
    ``rules`` are overrides over the defaults and the context. A mesh axis
    shards at most one dim: the earlier dim wins and the later drops it."""
    mesh = mesh or current_mesh()
    rules = ({**current_rules(), **rules} if rules is not None
             else current_rules())
    if mesh is None:
        return ()
    used: set = set()
    entries = []
    for n in names:
        axes = _resolve(n, mesh, rules)
        if axes is None:
            entries.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            entries.append(None)
        else:
            entries.append(axes if len(axes) > 1 else axes[0])
    return tuple(entries)


def axis_shards(name: str) -> int:
    """Into how many shards the active mesh and rules split a dim named
    ``name`` (1 without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    axes = _resolve(name, mesh, current_rules())
    if axes is None:
        return 1
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= mesh.shape[a]
    return n


def axis_index(name: str) -> int:
    """This rank's block of a dim named ``name`` under the active mesh and
    rules: its index among the :func:`axis_shards` blocks, the mesh axes
    taken jointly, the first the slowest (0 where the dim is whole)."""
    if axis_shards(name) == 1:
        return 0
    mesh = current_mesh()
    axes = _resolve(name, mesh, current_rules())
    idx = 0
    for a in ((axes,) if isinstance(axes, str) else axes):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def axis_group(name: str):
    """The process group a dim named ``name`` is sharded over under the
    active mesh and rules, or None where it is not split (no mesh, a
    replicated rule, an axis of size 1). The model code gathers or
    reduces over this group exactly where the serving rules put a
    collective."""
    if axis_shards(name) == 1:
        return None
    axes = _resolve(name, current_mesh(), current_rules())
    return current_mesh().group(axes)


def joint_group(*names: str):
    """The process group over every mesh axis (of size > 1) that splits
    any of the logical dims ``names`` under the active mesh and rules,
    taken jointly in the mesh's axis order; None where none is split.
    A per-tensor scale of a tensor split along several of them (a data
    shard's rows of a head group) reduces over this group."""
    mesh = current_mesh()
    if mesh is None:
        return None
    rules = current_rules()
    axes = set()
    for n in names:
        r = _resolve(n, mesh, rules)
        for a in ((r,) if isinstance(r, str) else (r or ())):
            if mesh.shape[a] > 1:
                axes.add(a)
    if not axes:
        return None
    return mesh.group(tuple(a for a in mesh.axis_names if a in axes))


def batch_group():
    """The process group the active rules split the batch over: a
    data-parallel mesh's data group (raising where the mesh holds none),
    None under the serving rules (which replicate the batch) or without
    a mesh. Every per-tensor scale of an activation or an error, the
    loss's label count and the router's statistics reduce over it."""
    return joint_group("batch")
