"""The kernels' ``meta`` route: each function returns what its kernel
returns, as ``meta`` tensors of the kernel's shapes and dtypes, and does
no arithmetic. A dry run (``launch.dryrun``) traces a step on the
``meta`` device through these; the dispatch layer charges each call's
cost (``kernels.costs``). Nothing sends a CPU or CUDA tensor here."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.lns import LNSFormat, lns_word_dtype
from repro_torch.kernels.madam_stats import MADAM_STAT_WIDTH
from repro_torch.kernels.ref import WG_K, WG_MN, shared_format

__all__ = ["encode_pack", "qmatmul", "qmatmul_decode", "paged_attend",
           "fused_sample", "fused_sample_seeded", "requant_pack",
           "requant_pack_many", "madam_step", "madam_step_stats",
           "madam_step_unpacked", "lns_matmul_packed", "padded"]


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def encode_pack(x, fmt: LNSFormat, scale_axis: Optional[int] = None,
                scale: Optional[torch.Tensor] = None):
    if scale is not None:
        want = (1, 1) if scale_axis is None else (x.shape[0], 1)
        if tuple(scale.shape) != want:
            raise ValueError(f"scale: expected shape {want}, got "
                             f"{tuple(scale.shape)}")
    return (_empty(x.shape, lns_word_dtype(fmt)),
            _empty((x.shape[0], 1), torch.float32))


def qmatmul(pa, pb, fmt, scale_a=None, scale_b=None, *,
            compute_dtype=torch.bfloat16, out_dtype=torch.float32):
    return _empty((pa.shape[0], pb.shape[1]), out_dtype)


def padded(M: int, K: int, N: int):
    """K2's decode pass's padded ``(Mp, Kp)`` and ``(Np, Kp)``."""
    kp = -(-K // WG_K) * WG_K
    return (-(-M // WG_MN) * WG_MN, kp), (-(-N // WG_MN) * WG_MN, kp)


def qmatmul_decode(pa, pb, fmt):
    a, b = padded(pa.shape[0], pa.shape[1], pb.shape[1])
    return _empty(a, torch.bfloat16), _empty(b, torch.bfloat16)


def paged_attend(q, kp, vp, k_scale, v_scale, block_table, lengths, *,
                 fmt=None, softcap=None, sm_scale):
    return _empty(q.shape, torch.float32)


def fused_sample(logits, gumbel, temp):
    return _empty((logits.shape[0],), torch.int32)


def fused_sample_seeded(logits, temp, seed, step, *, noise_out=False):
    out = _empty((logits.shape[0],), torch.int32)
    return (out, _empty(logits.shape, torch.float32)) if noise_out else out


def requant_pack(packed, src: LNSFormat, dst: LNSFormat):
    return _empty(packed.shape, lns_word_dtype(dst))


def requant_pack_many(leaves: Sequence[torch.Tensor], src,
                      dst) -> List[torch.Tensor]:
    leaves = list(leaves)
    shared_format(src, len(leaves), "src")
    dst = shared_format(dst, len(leaves), "dst")
    return [requant_pack(p, src, dst) for p in leaves]


def madam_step(packed, g, v, bc, fmt: LNSFormat, *, lr, beta, eps):
    return (_empty(packed.shape, lns_word_dtype(fmt)),
            _empty(v.shape, torch.float32))


def madam_step_stats(packed, g, v, bc, fmt: LNSFormat, *, lr, beta, eps,
                     requant=None):
    word, nv = madam_step(packed, g, v, bc, fmt, lr=lr, beta=beta, eps=eps)
    return word, nv, _empty((MADAM_STAT_WIDTH,), torch.float64)


def madam_step_unpacked(code, sign, g, v, bc, fmt, *, lr, beta, eps):
    return _empty(code.shape, code.dtype), _empty(v.shape, torch.float32)


def lns_matmul_packed(pa, pb, fmt, *, frac_bits=16, lut_entries=None,
                      block_k=16):
    return _empty((pa.shape[0], pb.shape[1]), torch.int32)
