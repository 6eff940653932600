"""Plain PyTorch versions of the four serving kernels.

Each function computes what its CUDA kernel computes, on any device. The
dispatch layer sends CPU tensors here; the tests hold these against the
JAX package's reference branches, and ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lns import (LNSFormat, compute_scale, lns_decode_packed,
                                  lns_encode, lns_pack)

__all__ = ["row_scale", "encode_pack", "qmatmul", "paged_attend",
           "fused_sample"]


def row_scale(x: torch.Tensor, scale_axis: Optional[int] = None):
    """The pow2 absmax scale of a 2-D ``x`` broadcast to ``(R, 1)`` f32:
    per tensor (``None``) or per row (``0``)."""
    scale = compute_scale(x, axis=scale_axis)
    s = scale.reshape(-1, 1) if scale.dim() else scale
    return s.expand(x.shape[0], 1).to(torch.float32).contiguous()


def encode_pack(x: torch.Tensor, fmt: LNSFormat,
                scale_axis: Optional[int] = None):
    """K1: Q_log-encode a 2-D tensor -> ``(packed (R,C), scale (R,1))``."""
    srow = row_scale(x, scale_axis)
    sign, code = lns_encode(x, fmt, srow)
    return lns_pack(sign, code, fmt), srow


def qmatmul(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat,
            scale_a: Optional[torch.Tensor] = None,
            scale_b: Optional[torch.Tensor] = None, *,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """K2: packed ``pa (M,K) @ pb (K,N)`` -> f32. Operands decode to
    ``compute_dtype``; products and sums run in f32 (a product of two
    bf16 values is exact in f32), then the row and column scales."""
    a = lns_decode_packed(pa, fmt, compute_dtype).to(torch.float32)
    b = lns_decode_packed(pb, fmt, compute_dtype).to(torch.float32)
    out = a @ b
    if scale_a is not None:
        out = out * scale_a
    if scale_b is not None:
        out = out * scale_b
    return out


def paged_attend(q, kp, vp, k_scale, v_scale, block_table, lengths, *,
                 fmt: Optional[LNSFormat] = None,
                 softcap: Optional[float] = None,
                 sm_scale: float) -> torch.Tensor:
    """K5: GQA attention of ``q (B,S,h,hd)`` over a paged pool
    ``(P,page,kv,hd)`` through ``block_table (B,max_pages)``; query ``s``
    of row ``b`` sits at ``lengths[b] - S + s`` (causal). f32 out."""
    B, S, h, hd = q.shape
    page, kv = kp.shape[1], kp.shape[2]
    mp = block_table.shape[1]
    cap = mp * page
    bt = block_table.long()

    def view(pool, scale):
        x = pool[bt].reshape(B, cap, kv, hd)
        if fmt is None:
            return x.to(torch.float32)
        s = scale[bt].reshape(B, cap, kv, 1)
        return lns_decode_packed(x, fmt, torch.float32) * s.to(torch.float32)

    rep = h // kv
    kf = view(kp, k_scale)
    vf = view(vp, v_scale)
    qg = q.to(torch.float32).reshape(B, S, kv, rep, hd)
    logits = torch.einsum("bsgrd,bkgd->bgrsk", qg, kf)
    logits = logits.reshape(B, h, S, cap) * sm_scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    abs_pos = torch.arange(cap, device=q.device)
    q_pos = (lengths.long() - S)[:, None] + torch.arange(S, device=q.device)
    mask = abs_pos[None, None, :] <= q_pos[:, :, None]          # (B, S, cap)
    logits = torch.where(mask[:, None], logits,
                         torch.full((), -1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bgrsk,bkgd->bsgrd",
                       p.reshape(B, kv, rep, S, cap), vf)
    return ctx.reshape(B, S, h, hd)


def fused_sample(logits: torch.Tensor, gumbel: Optional[torch.Tensor],
                 temp: Optional[torch.Tensor]) -> torch.Tensor:
    """K6: per row, the first-max-wins argmax of the logits, or of
    ``logits / max(t, 1e-6) + gumbel`` where ``t > 0``. int32 out."""
    lg = logits.to(torch.float32)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    if gumbel is None:
        return greedy
    scaled = lg / torch.clamp_min(temp, 1e-6)[:, None]
    toks = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temp > 0.0, toks, greedy)
