"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, on any device. The
dispatch layer sends CPU tensors here; the tests hold these against the
JAX package's reference branches, and ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import conversion
from repro_torch.core.lns import (LNSFormat, compute_scale, lns_decode_packed,
                                  lns_encode, lns_pack, lns_requant_packed,
                                  lns_unpack, lns_word_dtype)
from repro_torch.kernels.madam_stats import madam_stats_vec

__all__ = ["SAT24", "row_scale", "encode_pack", "qmatmul", "paged_attend",
           "fused_sample", "bias_correction", "step_math", "madam_step",
           "madam_step_stats", "madam_step_unpacked", "requant_pack",
           "lns_matmul_packed"]

SAT24 = (1 << 23) - 1  # the 24-bit accumulation collector's bound (Table 1)


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


def madam_step_unpacked(code: torch.Tensor, sign: torch.Tensor,
                        g: torch.Tensor, v: torch.Tensor, bc: float,
                        fmt: LNSFormat, *, lr: float, beta: float,
                        eps: float):
    """K9: the update of one leaf kept as ``(code, sign)`` ->
    ``(code' in code's dtype, v')``; K3's arithmetic without the
    packing. ``bc`` is :func:`bias_correction` of the step count."""
    new_code, nv, _ = step_math(code, sign, g, v, bc, lr=lr, beta=beta,
                                eps=eps, gamma=fmt.gamma,
                                max_code=fmt.max_code)
    return new_code.to(code.dtype), nv


def requant_pack(packed: torch.Tensor, src: LNSFormat,
                 dst: LNSFormat) -> torch.Tensor:
    """K7: re-grid packed words of any rank from ``src`` to ``dst`` bits;
    the integer function :func:`~repro_torch.core.lns.lns_requant_packed`
    itself, as the TPU kernel's body is."""
    return lns_requant_packed(packed, src, dst)


def lns_matmul_packed(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat, *,
                      frac_bits: int = 16, lut_entries: Optional[int] = None,
                      block_k: int = 16) -> torch.Tensor:
    """K8: the Fig.-6 integer datapath on packed ``pa (M,K) @ pb (K,N)``
    -> int32 partial sums in ``frac_bits`` fixed point (real value
    ``out · s_a·s_b / 2**frac_bits``).

    Per product: exponents add (``m = ca + cb``), signs multiply, and the
    magnitude is :func:`~repro_torch.core.conversion.exp2_neg_exact_fixed`
    of ``m`` (``exp2_neg_hybrid_fixed`` with ``lut_entries``). Each
    ``block_k`` slice of K sums in int32 and is added to the accumulator,
    which saturates to ±(2**23 - 1) after every slice; a partial last
    slice is one slice. The semantics of ``repro.kernels.ref.
    lns_matmul_ref``, walked one K slice at a time instead of building the
    (M, K, N) term tensor (7.2 GB of int32 at 2048×576×1536)."""
    sa, ca = lns_unpack(pa, fmt)
    sb, cb = lns_unpack(pb, fmt)
    neg_a, neg_b = sa < 0, sb < 0
    M, K = pa.shape
    acc = torch.zeros((M, pb.shape[1]), dtype=torch.int32, device=pa.device)
    for k0 in range(0, K, block_k):
        k1 = min(k0 + block_k, K)
        m = ca[:, k0:k1, None] + cb[None, k0:k1, :]
        if lut_entries is None:
            mag = conversion.exp2_neg_exact_fixed(m, fmt.gamma, frac_bits)
        else:
            mag = conversion.exp2_neg_hybrid_fixed(m, fmt.gamma, lut_entries,
                                                   frac_bits)
        neg = neg_a[:, k0:k1, None] ^ neg_b[None, k0:k1, :]
        block = torch.where(neg, -mag, mag).sum(dim=1, dtype=torch.int32)
        acc = torch.clamp(acc + block, -SAT24, SAT24)
    return acc
