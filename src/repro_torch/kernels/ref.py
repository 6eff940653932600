"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, on any device. The
dispatch layer sends CPU tensors here; the tests hold these against the
JAX package's reference branches, and ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import conversion
from repro_torch.core.lns import (LNSFormat, compute_scale, lns_decode_packed,
                                  lns_encode, lns_pack, lns_requant_packed,
                                  lns_unpack, lns_word_dtype)
from repro_torch.kernels.madam_stats import madam_stats_vec

__all__ = ["SAT24", "WG_MN", "WG_K", "row_scale", "encode_pack", "qmatmul",
           "qmatmul_decode", "paged_attend",
           "fused_sample", "gumbel_uniform", "gumbel_noise", "fused_sample_seeded",
           "bias_correction", "step_math", "madam_step",
           "madam_step_stats", "madam_step_unpacked", "requant_pack",
           "shared_format", "requant_pack_many", "lns_matmul_packed"]

SAT24 = (1 << 23) - 1  # the 24-bit accumulation collector's bound (Table 1)
# K2's wgmma tiles: its decode pass pads M and N to WG_MN, K to WG_K
WG_MN, WG_K = 128, 64


def row_scale(x: torch.Tensor, scale_axis: Optional[int] = None):
    """The pow2 absmax scale of a 2-D ``x`` broadcast to ``(R, 1)`` f32:
    per tensor (``None``) or per row (``0``)."""
    scale = compute_scale(x, axis=scale_axis)
    s = scale.reshape(-1, 1) if scale.dim() else scale
    return s.expand(x.shape[0], 1).to(torch.float32).contiguous()


def encode_pack(x: torch.Tensor, fmt: LNSFormat,
                scale_axis: Optional[int] = None,
                scale: Optional[torch.Tensor] = None):
    """K1: Q_log-encode a 2-D tensor -> ``(packed (R,C), scale (R,1))``,
    against its own pow2 absmax scale or a given ``scale`` (f32 ``(1,
    1)`` per tensor, ``(R, 1)`` per row)."""
    if scale is None:
        srow = row_scale(x, scale_axis)
    else:
        want = (1, 1) if scale_axis is None else (x.shape[0], 1)
        if tuple(scale.shape) != want:
            raise ValueError(f"scale: expected shape {want}, got "
                             f"{tuple(scale.shape)}")
        srow = scale.to(torch.float32).expand(x.shape[0], 1).contiguous()
    sign, code = lns_encode(x, fmt, srow)
    return lns_pack(sign, code, fmt), srow


def qmatmul(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat,
            scale_a: Optional[torch.Tensor] = None,
            scale_b: Optional[torch.Tensor] = None, *,
            compute_dtype=torch.bfloat16,
            out_dtype=torch.float32) -> torch.Tensor:
    """K2: packed ``pa (M,K) @ pb (K,N)`` -> ``out_dtype``. Operands decode
    to ``compute_dtype``; products and sums run in f32 (a product of two
    bf16 values is exact in f32), then the row and column scales, then one
    rounding to ``out_dtype``."""
    a = lns_decode_packed(pa, fmt, compute_dtype).to(torch.float32)
    b = lns_decode_packed(pb, fmt, compute_dtype).to(torch.float32)
    out = a @ b
    if scale_a is not None:
        out = out * scale_a
    if scale_b is not None:
        out = out * scale_b
    return out.to(out_dtype)


def qmatmul_decode(pa: torch.Tensor, pb: torch.Tensor, fmt: LNSFormat):
    """K2's decode pass: packed ``pa (M,K)`` and ``pb (K,N)`` -> bf16
    ``(ad (Mp,Kp), bt (Np,Kp))``, both K-major (``bt`` holds B
    transposed), zero past M, N and K (a zero bf16 is 0, unlike a zero
    word), Mp and Np whole multiples of ``WG_MN``, Kp of ``WG_K``."""
    (M, K), N = pa.shape, pb.shape[1]
    mp, np_, kp = (-(-M // WG_MN) * WG_MN, -(-N // WG_MN) * WG_MN,
                   -(-K // WG_K) * WG_K)
    ad = torch.zeros((mp, kp), dtype=torch.bfloat16, device=pa.device)
    bt = torch.zeros((np_, kp), dtype=torch.bfloat16, device=pa.device)
    ad[:M, :K] = lns_decode_packed(pa, fmt, torch.bfloat16)
    bt[:N, :K] = lns_decode_packed(pb, fmt, torch.bfloat16).T
    return ad, bt


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


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 ``x`` in [0, 2**32): ``m`` in 16-bit
    halves, so no product reaches 2**63."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit xor-shift-multiply finalizer of K6's noise (sampler.cu
    ``mix32``), a bijection of [0, 2**32), on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u32(a, device) -> torch.Tensor:
    """Host integers, or an integer tensor, mod 2**32 as int64 ``(B,)``."""
    if isinstance(a, torch.Tensor):
        return (a.to(device=device, dtype=torch.int64) & _M32).reshape(-1)
    return torch.as_tensor(np.asarray(a).astype(np.int64) & _M32,
                           device=device).reshape(-1)


def gumbel_uniform(seed, step, vocab: int, device=None) -> torch.Tensor:
    """The uniforms ``(B, vocab)`` f32 behind :func:`gumbel_noise`: per row
    ``key = mix32(mix32(seed) ^ step)``, per token id ``i``
    ``h = mix32(mix32(key ^ i) + key)`` and ``u = ((h >> 9) + 0.5) ·
    2**-23``, exact in f32 and strictly inside (0, 1). ``seed`` and
    ``step`` are ``(B,)`` integers (host arrays or tensors), taken mod
    2**32."""
    key = _mix32(_mix32(_u32(seed, device)) ^ _u32(step, device))[:, None]
    tok = torch.arange(vocab, dtype=torch.int64, device=device)[None]
    h = _mix32((_mix32(key ^ tok) + key) & _M32)
    return ((h >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def gumbel_noise(seed, step, vocab: int, device=None) -> torch.Tensor:
    """K6's counter-based gumbel noise ``(B, vocab)`` f32,
    ``-log(-log(u))`` of :func:`gumbel_uniform`: a function of (seed,
    step, token id) alone, so a sample event draws the same noise on any
    device (up to ``log``'s last bit) and whichever rows share its
    batch."""
    return -torch.log(-torch.log(gumbel_uniform(seed, step, vocab, device)))


def fused_sample_seeded(logits: torch.Tensor, temp, seed, step, *,
                        noise_out: bool = False):
    """K6, seeded: :func:`fused_sample` with the noise of
    :func:`gumbel_noise` and the rows ``temp``, ``seed``, ``step`` (host
    arrays, or tensors on the logits' device); with ``noise_out`` also
    returns that noise ``(B, V)``."""
    lg = logits.to(torch.float32)
    noise = gumbel_noise(seed, step, lg.shape[1], lg.device)
    t = (temp.to(torch.float32) if isinstance(temp, torch.Tensor) else
         torch.as_tensor(np.asarray(temp, np.float32), device=lg.device))
    out = fused_sample(lg, noise, t)
    return (out, noise) if noise_out else out


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


def shared_format(fmts, n: int, what: str) -> LNSFormat:
    """``fmts``: one format, or one for each of ``n`` leaves, all equal
    (the leaves of one K7 launch share ``src`` and ``dst``)."""
    if isinstance(fmts, LNSFormat):
        return fmts
    fmts = list(fmts)
    if len(fmts) != n or any(f != fmts[0] for f in fmts):
        raise ValueError(f"K7 re-grids leaves that share one (src, dst); "
                         f"the {what} formats differ or do not match the {n} "
                         f"leaves: {fmts}")
    return fmts[0]


def requant_pack_many(leaves: Sequence[torch.Tensor], src,
                      dst) -> List[torch.Tensor]:
    """K7 over several leaves that share ``(src, dst)`` (one format each,
    or one a leaf): :func:`requant_pack` of each."""
    leaves = list(leaves)
    src = shared_format(src, len(leaves), "src")
    dst = shared_format(dst, len(leaves), "dst")
    return [requant_pack(p, src, dst) for p in leaves]


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
