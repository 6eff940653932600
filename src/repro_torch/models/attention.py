"""GQA attention: the training path without a cache, and the two
serving cache layouts.

Without a cache (training) the KV heads are repeated to the query heads
and attended by :func:`flash_attention`, an online softmax over KV blocks
in plain torch; the JAX package runs the same scan through XLA, not a
Pallas kernel, and autograd gives its gradient here.

Two KV layouts, as in ``repro.models.attention``:

* **dense**: a ``(batch, max_len)`` buffer per layer with a per-row write
  cursor ``idx``; attention is plain torch (the JAX package leaves it to
  XLA as well);
* **paged**: one pool of ``page``-token pages per layer, shared by all
  rows through the engine's block table; attention is the paged kernel
  (``dispatch.paged_attend``, K5).

Unlike the JAX package, cache tensors are updated **in place**: the
engine owns them and nothing else holds a reference, so the functional
copy would only cost memory. With ``cfg.kv_cache_bits`` the caches hold
packed LNS words plus a per-(position, head) bf16 scale.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.lns import (LNSFormat, compute_scale, lns_decode,
                                  lns_encode, lns_pack, lns_unpack)
from repro_torch.core.quantizer import QuantConfig, qeinsum, ste_quantize
from repro_torch.kernels import dispatch
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import apply_rope, dense_of, rope

__all__ = ["attn_apply", "flash_attention", "init_kv_cache",
           "init_paged_kv_cache", "is_paged_cache"]


def _qa(x: torch.Tensor, qcfg: Optional[QuantConfig]):
    """Q_A on the attention operands (per tensor, straight through)."""
    if qcfg is not None and qcfg.act is not None:
        return ste_quantize(x, qcfg.act, None)
    return x


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return logits if cap is None else cap * torch.tanh(logits / cap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: Optional[float] = None,
                    block_k: int = 512) -> torch.Tensor:
    """Causal online-softmax attention over KV blocks of ``block_k``.
    q, k, v: (B, S, H, D) with the KV heads already repeated. f32 inside,
    ``q.dtype`` out."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    block_k = min(block_k, Skv)
    if Skv % block_k:
        raise ValueError(f"KV length {Skv} must tile by {block_k}")
    qf = q.to(torch.float32) * (1.0 / math.sqrt(D))
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    neg = torch.full((), -1e30, device=q.device)
    for start in range(0, Skv, block_k):
        k_blk = k[:, start:start + block_k].to(torch.float32)
        v_blk = v[:, start:start + block_k].to(torch.float32)
        k_pos = start + torch.arange(block_k, device=q.device)
        logits = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, k_blk), softcap)
        mask = k_pos[None, :] <= q_pos[:, None]                   # (Sq, blk)
        logits = torch.where(mask[None, None], logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attn_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig,
               qcfg: Optional[QuantConfig], *, positions: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One attention block over ``x`` (B, S, D). Without ``cache``
    (training) the S positions attend causally among themselves; with one
    (append mode) they are written to ``cache`` and attended with what it
    holds."""
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = qeinsum("bsd,de->bse", x, dense_of(p["wq"], cfg), qcfg)
    k = qeinsum("bsd,de->bse", x, dense_of(p["wk"], cfg), qcfg)
    v = qeinsum("bsd,de->bse", x, dense_of(p["wv"], cfg), qcfg)
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    rot = rope(positions, hd, cfg.rope_theta)
    if rot.dim() == 3:
        rot = rot[None]
    q = _qa(apply_rope(q, rot), qcfg)
    k = _qa(apply_rope(k, rot), qcfg)
    v = _qa(v, qcfg)
    if cache is None:
        rep = h // kv
        out = flash_attention(q, k.repeat_interleave(rep, dim=2),
                              v.repeat_interleave(rep, dim=2),
                              softcap=cfg.attn_logit_softcap)
    elif is_paged_cache(cache):
        if block_table is None:
            raise ValueError("a paged cache needs the block table")
        out = _paged_attend(q, k, v, cache, cfg, block_table)
    else:
        out = _decode_attend(q, k, v, cache, cfg)
    out = out.reshape(B, S, h * hd)
    return qeinsum("bse,ed->bsd", out, dense_of(p["wo"], cfg), qcfg)


def init_kv_cache(batch: int, max_len: int, cfg: ArchConfig,
                  device) -> Dict[str, torch.Tensor]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, max_len, kv, hd)
    idx = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.kv_cache_bits:
        sshape = (batch, max_len, kv, 1)
        return {"k": torch.zeros(shape, dtype=torch.uint8, device=device),
                "v": torch.zeros(shape, dtype=torch.uint8, device=device),
                "k_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                      device=device),
                "v_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                      device=device),
                "idx": idx}
    dt = cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "idx": idx}


def init_paged_kv_cache(batch: int, num_pages: int, page_size: int,
                        cfg: ArchConfig, device) -> Dict[str, torch.Tensor]:
    """``num_pages + 1`` pages: the last is the null page that unused
    block-table entries point at."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (num_pages + 1, page_size, kv, hd)
    idx = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.kv_cache_bits:
        sshape = (num_pages + 1, page_size, kv, 1)
        return {"kp": torch.zeros(shape, dtype=torch.uint8, device=device),
                "vp": torch.zeros(shape, dtype=torch.uint8, device=device),
                "kp_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                       device=device),
                "vp_scale": torch.ones(sshape, dtype=torch.bfloat16,
                                       device=device),
                "idx": idx}
    dt = cfg.compute_dtype
    return {"kp": torch.zeros(shape, dtype=dt, device=device),
            "vp": torch.zeros(shape, dtype=dt, device=device), "idx": idx}


def is_paged_cache(cache) -> bool:
    return isinstance(cache, dict) and "kp" in cache


def _kv_fmt(cfg: ArchConfig) -> LNSFormat:
    return LNSFormat(bits=cfg.kv_cache_bits, gamma=8)


def _kv_encode(x: torch.Tensor, cfg: ArchConfig):
    """(B,S,KV,hd) -> packed words + a per-(position, head) bf16 scale."""
    fmt = _kv_fmt(cfg)
    scale = compute_scale(x, axis=(0, 1, 2))
    sign, code = lns_encode(x, fmt, scale)
    return lns_pack(sign, code, fmt), scale.to(torch.bfloat16)


def _kv_decode(packed: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig):
    sign, code = lns_unpack(packed, _kv_fmt(cfg))
    return lns_decode(sign, code, _kv_fmt(cfg), scale.to(torch.float32),
                      dtype=cfg.compute_dtype)


def _decode_attend(q, k_new, v_new, cache, cfg: ArchConfig):
    """Write S new positions at each row's cursor (clamped to the buffer,
    as a dynamic slice update clamps) and attend with a causal mask."""
    B, S, h, hd = q.shape
    kv = cfg.num_kv_heads
    idx = cache["idx"].long()
    cap = cache["k"].shape[1]
    ar = torch.arange(S, device=q.device)
    q_abs = idx[:, None] + ar                                   # (B, S)
    start = torch.clamp(idx, max=cap - S)
    rows = torch.arange(B, device=q.device)[:, None]
    cols = start[:, None] + ar
    if cfg.kv_cache_bits:
        pk, sk = _kv_encode(k_new, cfg)
        pv, sv = _kv_encode(v_new, cfg)
        store = (("k", pk), ("v", pv), ("k_scale", sk), ("v_scale", sv))
    else:
        store = (("k", k_new), ("v", v_new))
    for key, new in store:
        cache[key][rows, cols] = new.to(cache[key].dtype)
    if cfg.kv_cache_bits:
        k_att = _kv_decode(cache["k"], cache["k_scale"], cfg)
        v_att = _kv_decode(cache["v"], cache["v_scale"], cfg)
    else:
        k_att, v_att = cache["k"], cache["v"]
    slot = torch.arange(cap, device=q.device)
    valid = slot[None, :] < (idx[:, None] + S)                  # (B, cap)
    rep = h // kv
    kf = k_att.repeat_interleave(rep, dim=2).to(torch.float32)
    vf = v_att.repeat_interleave(rep, dim=2).to(torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kf) / math.sqrt(hd)
    logits = _softcap(logits, cfg.attn_logit_softcap)
    mask = valid[:, None, :] & (slot[None, None, :] <= q_abs[:, :, None])
    logits = torch.where(mask[:, None], logits,
                         torch.full((), -1e30, device=q.device))
    p_attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p_attn, vf)
    cache["idx"] += S
    return out.to(q.dtype)


def _paged_attend(q, k_new, v_new, cache, cfg: ArchConfig,
                  block_table: torch.Tensor):
    """Scatter the S new positions into the row's pages (positions past
    the table's span are dropped), then attend through K5."""
    B, S, h, hd = q.shape
    pool_k = cache["kp"]
    page = pool_k.shape[1]
    mp = block_table.shape[1]
    idx = cache["idx"].long()
    pos = idx[:, None] + torch.arange(S, device=q.device)       # (B, S)
    pg = torch.gather(block_table.long(), 1, torch.clamp(pos // page, 0,
                                                         mp - 1))
    keep = (pos < mp * page).reshape(-1)
    fpg, foff = pg.reshape(-1)[keep], (pos % page).reshape(-1)[keep]
    quant = bool(cfg.kv_cache_bits)
    if quant:
        pk, sk = _kv_encode(k_new, cfg)
        pv, sv = _kv_encode(v_new, cfg)
        store = (("kp", pk), ("vp", pv), ("kp_scale", sk), ("vp_scale", sv))
    else:
        store = (("kp", k_new), ("vp", v_new))
    for key, new in store:
        flat = new.reshape((B * S,) + tuple(new.shape[2:]))[keep]
        cache[key][fpg, foff] = flat.to(cache[key].dtype)
    cache["idx"] += S
    out = dispatch.paged_attend(
        q.contiguous(), cache["kp"], cache["vp"], cache.get("kp_scale"),
        cache.get("vp_scale"), block_table, cache["idx"],
        fmt=_kv_fmt(cfg) if quant else None,
        softcap=cfg.attn_logit_softcap, sm_scale=1.0 / math.sqrt(hd))
    return out.to(q.dtype)
