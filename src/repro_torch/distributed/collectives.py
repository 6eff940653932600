"""The collectives of the mesh forward, over one process group.

Only two kinds run in the serving forward, each at a point the serving
rules fix (``repro_torch.distributed.sharding``):

* :func:`gather` concatenates each rank's block of a dim in rank order:
  the all-gather epilogue after a column-parallel GEMM, a head-sharded
  attention, or the expert-parallel FFN. It moves bytes and adds
  nothing, so the result is the single device's bit for bit.
* :func:`max_reduce` takes the elementwise max over ranks: the global
  absmax behind a per-tensor scale of a sharded tensor. A max is exact in
  any order.

No sum is ever reduced across ranks in the serving forward. The training
collectives (``optim.compression``) sum. Both run on NCCL for CUDA
tensors and gloo for CPU ones, whichever backend the group was made with.
"""
from __future__ import annotations

import torch

__all__ = ["gather", "max_reduce", "group_size", "broadcast_object",
           "counts", "reset_counts"]

# collectives issued (over a group of more than one rank) since the last
# reset, by kind: what a step or a forward costs in round trips
_COUNTS = {"gather": 0, "max_reduce": 0}


def counts() -> dict:
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def group_size(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (identity without a group)."""
    n = group_size(group)
    if n == 1:
        return x
    import torch.distributed as dist
    _COUNTS["gather"] += 1
    dim = dim % x.dim()
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=xm.dtype, device=xm.device)
    agather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    agather(out, xm, group=group)
    return out.movedim(0, dim)


def max_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the group (a new tensor)."""
    if group_size(group) == 1:
        return t
    import torch.distributed as dist
    _COUNTS["max_reduce"] += 1
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank of ``group`` (the
    world by default)."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
