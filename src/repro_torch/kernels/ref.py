"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, on any device. The
dispatch layer sends CPU tensors here; the tests hold these against the
JAX package's reference branches, and ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lns import (LNSFormat, compute_scale, lns_decode_packed,
                                  lns_encode, lns_pack, lns_requant_packed,
                                  lns_word_dtype)
from repro_torch.kernels.madam_stats import madam_stats_vec

__all__ = ["row_scale", "encode_pack", "qmatmul", "paged_attend",
           "fused_sample", "bias_correction", "step_math", "madam_step",
           "madam_step_stats", "requant_pack"]


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


def bias_correction(beta: float, count: int) -> float:
    """``1 - beta**count`` as the JAX package computes it: an f32 pow of
    f32 ``beta``, then an f32 subtract (not Python's double pow, which
    rounds differently). A host float holding the f32 value exactly."""
    b = torch.tensor(beta, dtype=torch.float32)
    return float(1.0 - b ** float(count))


def step_math(code: torch.Tensor, sign: torch.Tensor, g: torch.Tensor,
              v: torch.Tensor, bc: float, *, lr: float, beta: float,
              eps: float, gamma: int, max_code: int):
    """Algorithm 1 on one leaf, in the op order of the JAX ``_step_math``;
    returns ``(new_code f32, new_v, target)``. The Python constants round
    to f32 as JAX's weak types do. ``bc`` divides as a device tensor: ATen
    on CUDA turns a division by a Python scalar into a multiply by its
    reciprocal, which rounds differently from the kernel's IEEE divide."""
    g = g.to(torch.float32)
    v = (1.0 - beta) * g * g + beta * v
    bc_t = torch.full((), bc, dtype=torch.float32, device=v.device)
    gstar = g * torch.rsqrt(v / bc_t + eps)
    target = code.to(torch.float32) + (lr * gamma) * gstar * sign.to(
        torch.float32)
    return torch.clamp(torch.floor(target + 0.5), 0, max_code), v, target


def _madam(packed, g, v, bc, fmt: LNSFormat, lr, beta, eps):
    w = packed.to(torch.int32)
    sign_bit = (w >> (fmt.bits - 1)) & 1
    code = w & fmt.max_code
    new_code, nv, target = step_math(code, 1 - 2 * sign_bit, g, v, bc, lr=lr,
                                     beta=beta, eps=eps, gamma=fmt.gamma,
                                     max_code=fmt.max_code)
    word = (sign_bit << (fmt.bits - 1)) | new_code.to(torch.int32)
    return word.to(lns_word_dtype(fmt)), nv, code, target, new_code


def madam_step(packed: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
               bc: float, fmt: LNSFormat, *, lr: float, beta: float,
               eps: float):
    """K3: the fused update of one 2-D packed leaf -> ``(words', v')``.
    ``bc`` is :func:`bias_correction` of the step count."""
    word, nv, _, _, _ = _madam(packed, g, v, bc, fmt, lr, beta, eps)
    return word, nv


def madam_step_stats(packed: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     bc: float, fmt: LNSFormat, *, lr: float, beta: float,
                     eps: float, requant=None):
    """K4: :func:`madam_step` plus the summed stat vector (f64, width 8;
    layout in ``kernels.madam_stats``)."""
    word, nv, code, target, new_code = _madam(packed, g, v, bc, fmt, lr,
                                              beta, eps)
    vec = madam_stats_vec(code, target, new_code, gamma=fmt.gamma,
                          max_code=fmt.max_code, requant=requant)
    return word, nv, vec


def requant_pack(packed: torch.Tensor, src: LNSFormat,
                 dst: LNSFormat) -> torch.Tensor:
    """K7: re-grid packed words of any rank from ``src`` to ``dst`` bits;
    the integer function :func:`~repro_torch.core.lns.lns_requant_packed`
    itself, as the TPU kernel's body is."""
    return lns_requant_packed(packed, src, dst)
