"""The collectives of the mesh forward and of the data-parallel step,
over one process group.

Two kinds run in the forward, each at a point the rules fix
(``repro_torch.distributed.sharding``):

* :func:`gather` concatenates each rank's block of a dim in rank order:
  the all-gather epilogue after a column-parallel GEMM, a head-sharded
  attention, or the expert-parallel FFN. It moves bytes and adds
  nothing, so the result is the single device's bit for bit.
* :func:`max_reduce` takes the elementwise max over ranks: the global
  absmax behind a per-tensor scale of a sharded tensor (a head group's
  under serving, a data shard's rows in training). A max is exact in any
  order.

No sum is ever reduced across ranks in the serving forward. The
tensor-parallel train step's forward under ``sharding.train_rules`` does
(:func:`sum_forward`): each row-parallel GEMM's partial product, and the
vocabulary-parallel lookup and cross entropy. The data-parallel train
step sums (:func:`sum_reduce`, :func:`sum_tensors`):
the gradients, the loss's label count and the router's route counts.
The compression psums (``optim.compression``) sum too. All run on NCCL
for CUDA tensors and gloo for CPU ones, whichever backend the group was
made with.

The tensor-parallel train step differentiates through the model group's
collectives, in two autograd functions that are each other's transpose:

* :func:`gather_with_grad` is :func:`gather` with a backward: this
  rank's block of the incoming gradient. Everything after a gather is
  replicated over the group, so that gradient is the same on every rank
  and the block is the rank's whole share of it.
* :func:`sum_grad` is the identity in the forward and a SUM over the
  group in the backward. It stands at the input of each column-parallel
  GEMM (and on a replicated leaf read inside the split region, such as
  a qk-norm gain): each rank's gradient there is its columns' part of the
  whole, and their sum is the single device's.

A plain :func:`gather` of a tensor that requires a gradient raises:
``all_gather_into_tensor`` writes into a tensor autograd does not track,
so the gradient would be dropped without a word.
"""
from __future__ import annotations

import torch

__all__ = ["gather", "gather_with_grad", "sum_grad", "sum_forward",
           "max_reduce",
           "sum_reduce", "sum_tensors",
           "group_size", "broadcast_object", "counts", "reset_counts",
           "name_group", "byte_counts", "SUM_BUCKET_BYTES"]

# collectives issued (over a group of more than one rank) since the last
# reset, by kind: what a step or a forward costs in round trips; "sum"
# counts every SUM all-reduce, a gradient bucket included
_COUNTS = {"gather": 0, "max_reduce": 0, "sum": 0}
# their operand bytes (a rank's) and calls since the last reset, by kind
# as the JAX package's roofline names them ("all-gather", "all-reduce";
# "broadcast" for broadcast_object's pickled bytes) and by the mesh axes
# the group spans (:func:`name_group`; "?" for a group no mesh named)
_BYTES: dict = {}
_AXES: dict = {}

# the f32 staging buffer of one SUM bucket: the gradients reduce through
# it a bucket at a time, so the temporary stays this size whatever the
# model (gemma3-12b's 1.0e9-element embedding gradient takes 16 buckets)
SUM_BUCKET_BYTES = 256 << 20


def counts() -> dict:
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0
    _BYTES.clear()


def name_group(group, axes: str) -> None:
    """Record that ``group`` spans the mesh axes ``axes`` (``"model"``,
    ``"data+model"``...), the key its collectives' bytes are counted
    under."""
    _AXES[group] = axes


def _charge(kind: str, group, nbytes: int) -> None:
    row = _BYTES.setdefault((kind, _AXES.get(group, "?")), [0, 0])
    row[0] += 1
    row[1] += int(nbytes)


def byte_counts() -> dict:
    """Since the last reset: ``{"bytes": {kind: n}, "calls": {kind: n},
    "by_axis": {axes: {kind: n}}}``, a rank's operand bytes."""
    out = {"bytes": {}, "calls": {}, "by_axis": {}}
    for (kind, axes), (calls, nbytes) in sorted(_BYTES.items()):
        out["bytes"][kind] = out["bytes"].get(kind, 0) + nbytes
        out["calls"][kind] = out["calls"].get(kind, 0) + calls
        out["by_axis"].setdefault(axes, {})[kind] = nbytes
    return out


def group_size(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (identity without a group). No gradient flows through it: a tensor
    that requires one raises (:func:`gather_with_grad` carries it)."""
    n = group_size(group)
    if n == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("collectives.gather drops the gradient of a "
                           "tensor that requires one; use "
                           "gather_with_grad")
    return _all_gather(x, group, dim, n)


def _all_gather(x: torch.Tensor, group, dim: int, n: int) -> torch.Tensor:
    import torch.distributed as dist
    _COUNTS["gather"] += 1
    _charge("all-gather", group, x.numel() * x.element_size())
    dim = dim % x.dim()
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=xm.dtype, device=xm.device)
    agather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    agather(out, xm, group=group)
    return out.movedim(0, dim)


class _GatherWithGrad(torch.autograd.Function):
    """The all-gather forward; the backward takes this rank's block of
    the gradient (the group and the rank's index are taken in the
    forward: the backward may run on autograd's device thread)."""

    @staticmethod
    def forward(ctx, x, group, dim, n):
        import torch.distributed as dist
        ctx.dim, ctx.width = dim % x.dim(), x.shape[dim]
        ctx.index = dist.get_rank(group)
        return _all_gather(x, group, dim, n)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width), None, None, None


def gather_with_grad(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """:func:`gather` whose gradient is this rank's block of the
    incoming gradient (the module docstring). Without a gradient to carry
    it is :func:`gather`, with no autograd node."""
    n = group_size(group)
    if n == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _all_gather(x, group, dim, n)
    return _GatherWithGrad.apply(x, group, dim, n)


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient SUM-reduced over the group (taken
    in the forward, as :class:`_GatherWithGrad`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_reduce(g.contiguous(), ctx.group), None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is SUM-reduced over ``group`` in the
    backward: the transpose of a replicated input read by a split
    computation (the module docstring). No node without a group or a
    gradient."""
    if group_size(group) == 1 or not (torch.is_grad_enabled()
                                      and x.requires_grad):
        return x
    return _SumGrad.apply(x, group)


class _SumForward(torch.autograd.Function):
    """The SUM all-reduce forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return sum_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``x`` over ``group``, whose gradient is the
    incoming one unchanged (the module docstring): a row-parallel GEMM's
    partials made whole. ``x`` itself without a group; no node without a
    gradient."""
    if group_size(group) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return sum_reduce(x.contiguous(), group)
    return _SumForward.apply(x, group)


def max_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the group (a new tensor)."""
    if group_size(group) == 1:
        return t
    import torch.distributed as dist
    _COUNTS["max_reduce"] += 1
    _charge("all-reduce", group, t.numel() * t.element_size())
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def sum_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``t`` over the group (a new tensor; ``t``
    itself without a group)."""
    if group_size(group) == 1:
        return t
    import torch.distributed as dist
    _COUNTS["sum"] += 1
    _charge("all-reduce", group, t.numel() * t.element_size())
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def sum_tensors(ts, group, bucket_bytes: int = SUM_BUCKET_BYTES) -> None:
    """Sum each tensor of ``ts`` over the group's ranks, in place: the
    elements are copied into an f32 bucket of at most ``bucket_bytes``
    (small tensors share one, a large one takes as many as it fills),
    the bucket is SUM-reduced, and each sum is cast back to its tensor's
    dtype once. Every rank must pass the same shapes in the same order.
    Nothing happens without a group."""
    if group_size(group) == 1:
        return
    import torch.distributed as dist
    ts = [t for t in ts if t.numel()]
    if not ts:
        return
    cap = max(1, bucket_bytes // 4)
    cap = min(cap, sum(t.numel() for t in ts))
    buf = torch.empty((cap,), dtype=torch.float32, device=ts[0].device)
    pending, used = [], 0      # (flat view, start in the view, n, at)

    def flush():
        nonlocal used
        if not used:
            return
        _COUNTS["sum"] += 1
        _charge("all-reduce", group, used * 4)
        dist.all_reduce(buf[:used], op=dist.ReduceOp.SUM, group=group)
        for flat, lo, n, at in pending:
            flat[lo:lo + n].copy_(buf[at:at + n])
        pending.clear()
        used = 0

    for t in ts:
        if not t.is_contiguous():
            raise ValueError("sum_tensors reduces contiguous tensors in "
                             "place")
        flat = t.view(-1)
        lo = 0
        while lo < flat.numel():
            n = min(flat.numel() - lo, cap - used)
            buf[used:used + n].copy_(flat[lo:lo + n])
            pending.append((flat, lo, n, used))
            used += n
            lo += n
            if used == cap:
                flush()
    flush()


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank of ``group`` (the
    world by default); its pickled bytes are counted as a broadcast."""
    import pickle
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    _charge("broadcast", group if group is not None else dist.group.WORLD,
            len(pickle.dumps(box[0])))
    return box[0]
