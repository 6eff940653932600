"""GQA attention (± QKV bias / qk-norm / sliding window / softcap) and
MLA (deepseek-v3's multi-head latent attention): the training path
without a cache, and the serving cache layouts.

Without a cache (training) the KV heads are repeated to the query heads
and attended by :func:`flash_attention`, an online softmax over KV blocks
in plain torch; the JAX package runs the same scan through XLA, not a
Pallas kernel, and autograd gives its gradient here.

Two KV layouts, as in ``repro.models.attention``:

* **dense**: a ``(batch, max_len)`` buffer per layer with a per-row write
  cursor ``idx``; attention is plain torch (the JAX package leaves it to
  XLA as well). A sliding-window layer's buffer is a ring of
  ``min(window, max_len)`` positions (``init_kv_cache(window=)``), also
  plain torch: ring slot ``s`` holds the position ``p = s (mod cap)``;
* **paged**: one pool of ``page``-token pages per layer, shared by all
  rows through the engine's block table; attention is the paged kernel
  (``dispatch.paged_attend``, K5). Paged pools serve full-context layers
  only: a window layer keeps its ring.

MLA is never paged: its cache holds the KV latent ``c_kv`` and the rope
key of every position, ``(batch, max_len)`` a layer, and every cached
call (prefill and decode) attends in the absorbed form, in f32, with
``kv_up`` folded into the query and the context (:func:`_mla_decode`).

Under the decode rules (``distributed.sharding.decode_rules``, split-KV
decode) a dense cache and an MLA latent cache hold one contiguous block of
positions a rank, every KV head. The new positions are written on the
rank whose block holds them; each rank attends its block
(:func:`partial_attend`, grouped, in f32 chunks of the block) and the
partial results merge over the ``kv_seq`` group (:func:`merge_partials`:
a MAX reduce of the maxima, one SUM reduce of the rescaled sums and
outputs). Rings, pools and recurrent state keep the serving placement.

Unlike the JAX package, cache tensors are updated **in place**: the
engine owns them and nothing else holds a reference, so the functional
copy would only cost memory. With ``cfg.kv_cache_bits`` the caches hold
packed LNS words plus a per-(position, head) bf16 scale.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.lns import (LNSFormat, compute_scale, lns_decode,
                                  lns_encode, lns_pack, lns_unpack)
from repro_torch.core.quantizer import (QuantConfig, act_stat, qeinsum,
                                        ste_quantize, ste_quantize_sharded)
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (axis_group, axis_index,
                                              axis_shards, joint_group)
from repro_torch.kernels import dispatch
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (apply_rope, decoded_of, dense_of,
                                       rms_norm, rope)

__all__ = ["attn_apply", "attn_zero_leaves", "flash_attention",
           "init_kv_cache", "init_paged_kv_cache", "is_paged_cache",
           "mla_leaves", "mla_apply", "init_mla_cache", "partial_attend",
           "merge_partials", "split_kv"]

# positions of a rank's block cast to f32 at a time by the split-KV
# attention: its f32 temporaries stay this many positions of K or V
SPLIT_CHUNK = 8192


def _qa(xs, cfg: ArchConfig, qcfg: Optional[QuantConfig]):
    """Q_A on each attention operand of ``xs`` (per tensor, straight
    through), unless ``cfg.quantize_attention`` is off. Where the operands
    are split over ranks (a head group under serving, a data shard's rows
    in training, or both) each scale is the whole tensor's, all of them
    max-reduced over the joint group in one collective."""
    if qcfg is None or not cfg.quantize_attention or qcfg.act is None:
        return list(xs)
    group = joint_group("batch", "qkv_out")
    if group is not None:
        return ste_quantize_sharded(xs, qcfg.act, group)
    return [ste_quantize(x, qcfg.act, None) for x in xs]


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """Causal, and within ``window`` positions when one is given."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return logits if cap is None else cap * torch.tanh(logits / cap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_k: int = 512) -> torch.Tensor:
    """Causal online-softmax attention over KV blocks of ``block_k``,
    each query seeing the last ``window`` positions when one is given.
    q, k: (B, S, H, D) with the KV heads already repeated; v (B, S, H,
    Dv) may be narrower than q and k (MLA's v_head_dim), and the scale is
    1/sqrt(D) of q's width. f32 inside, ``q.dtype`` out. A KV length that
    ``block_k`` does not divide ends in a shorter block (the JAX package
    asserts that it divides: phi-3-vision's 576 patches plus 64 or 256
    text positions do not tile by 512, ROADMAP H15); where it divides,
    the blocks are the JAX package's."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    block_k = min(block_k, Skv)
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
        k_pos = start + torch.arange(k_blk.shape[1], device=q.device)
        logits = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, k_blk), softcap)
        mask = _mask(q_pos, k_pos, window)                        # (Sq, blk)
        logits = torch.where(mask[None, None], logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attn_zero_leaves(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                         torch.dtype]]:
    """``name -> (shape, dtype)`` of the attention leaves that start at
    zero, in the JAX package's order: ``bq/bk/bv`` (compute dtype) with
    ``qkv_bias``, ``q_norm`` and ``k_norm`` (f32 gains, applied as
    ``1 + gain``) with ``qk_norm``."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.qkv_bias:
        out["bq"] = ((h * hd,), cfg.compute_dtype)
        out["bk"] = ((kv * hd,), cfg.compute_dtype)
        out["bv"] = ((kv * hd,), cfg.compute_dtype)
    if cfg.qk_norm:
        out["q_norm"] = ((hd,), torch.float32)
        out["k_norm"] = ((hd,), torch.float32)
    return out


def attn_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig,
               qcfg: Optional[QuantConfig], *, positions: torch.Tensor,
               window: Optional[int] = None, theta: Optional[float] = None,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One attention block over ``x`` (B, S, D). Without ``cache``
    (training) the S positions attend causally among themselves; with one
    (append mode) they are written to ``cache`` and attended with what it
    holds. ``window`` limits what a query sees to the last ``window``
    positions; ``theta`` is the rope base (default ``cfg.rope_theta``).
    The order is the JAX package's: projections, bias, qk-norm, rope,
    Q_A.

    Under a mesh whose serving rules shard ``qkv_out`` (both head counts
    divide the ``model`` axis), ``wq/wk/wv`` and the biases are this
    rank's contiguous column blocks, so the rank computes its own query
    heads and their KV heads (GQA groups are contiguous), keeps only those
    in its caches and pools, and all-gathers the heads before the
    replicated ``wo``; Q_A's per-tensor scales are max-reduced over the
    ranks first. Where ``wq/wk/wv`` are held whole on every rank
    (``params_sharding.kept_whole``: zamba2's LoRA-merged shared QKV) the
    projections run at the whole width, as on one card, and the rank keeps
    its heads' columns of each.

    A dense cache split by position (:func:`split_kv`) takes every head:
    a head group's q, k and v are gathered after Q_A (one all-gather;
    a whole-width projection keeps all its heads), the rank attends its
    block for every head, and after the merge every rank holds every
    head's output, so none is gathered before ``wo``.

    In training (tensor-parallel, heads over the model group) the heads'
    gather passes back the rank's block of the gradient, and ``x``'s
    gradient and the qk-norm gains' (replicated leaves read by the rank's
    heads only) are SUM-reduced over the group
    (``collectives.sum_grad``); Q_E's scale of a column block's output is
    the whole tensor's. Where the rules also split ``attn_out``
    (``sharding.train_rules``), ``wo`` holds this rank's rows: the rank's
    heads are not gathered but encoded with the whole output's Q_A scale
    (MAX-reduced over the batch and model groups) and multiplied against
    those rows, and the partial products are SUM-reduced over the group
    in f32 (``collectives.sum_forward``), then rounded once."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    grp = axis_group("qkv_out")
    split = (cache is not None and not window and not is_paged_cache(cache)
             and split_kv())
    theta = theta if theta is not None else cfg.rope_theta
    x = collectives.sum_grad(x, grp)
    xs = act_stat(x, qcfg)        # one reduce for the three projections
    q = qeinsum("bsd,de->bse", x, dense_of(p["wq"], cfg), qcfg, x_stat=xs,
                out_axis="qkv_out")
    k = qeinsum("bsd,de->bse", x, dense_of(p["wk"], cfg), qcfg, x_stat=xs,
                out_axis="qkv_out")
    v = qeinsum("bsd,de->bse", x, dense_of(p["wv"], cfg), qcfg, x_stat=xs,
                out_axis="qkv_out")
    m = axis_shards("qkv_out")
    if m > 1 and q.shape[-1] == cfg.num_heads * hd and not split:  # whole
        i = axis_index("qkv_out")
        q, k, v = (t.narrow(-1, i * (t.shape[-1] // m), t.shape[-1] // m)
                   for t in (q, k, v))
    h, kv = q.shape[-1] // hd, k.shape[-1] // hd     # this rank's heads
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, collectives.sum_grad(p["q_norm"], grp), cfg.norm_eps)
        k = rms_norm(k, collectives.sum_grad(p["k_norm"], grp), cfg.norm_eps)
    rot = rope(positions, hd, theta)
    if rot.dim() == 3:
        rot = rot[None]
    q, k, v = _qa((apply_rope(q, rot), apply_rope(k, rot), v), cfg, qcfg)
    if split:
        if h < cfg.num_heads:
            q, k, v = _gather_heads((q, k, v), grp)
        out = _split_decode_attend(q, k, v, cache, cfg)
        out = out.reshape(B, S, cfg.num_heads * hd)
        return qeinsum("bse,ed->bsd", out, dense_of(p["wo"], cfg), qcfg)
    if cache is None:
        rep = h // kv
        out = flash_attention(q, k.repeat_interleave(rep, dim=2),
                              v.repeat_interleave(rep, dim=2), window=window,
                              softcap=cfg.attn_logit_softcap)
    elif is_paged_cache(cache):
        if window is not None:
            raise ValueError("paged KV pools do not serve ring buffers")
        if block_table is None:
            raise ValueError("a paged cache needs the block table")
        out = _paged_attend(q, k, v, cache, cfg, block_table)
    elif window:
        out = _ring_attend(q, k, v, cache, cfg, window)
    else:
        out = _decode_attend(q, k, v, cache, cfg)
    rows = axis_group("attn_out")
    if rows is not None:          # wo holds this rank's rows
        out = out.reshape(B, S, h * hd)
        y = qeinsum("bse,ed->bsd", out, dense_of(p["wo"], cfg), qcfg,
                    x_stat=act_stat(out, qcfg, "attn_out"),
                    out_dtype=torch.float32)
        return collectives.sum_forward(y, rows).to(out.dtype)
    out = collectives.gather_with_grad(out, grp, dim=2)
    out = out.reshape(B, S, out.shape[2] * hd)
    return qeinsum("bse,ed->bsd", out, dense_of(p["wo"], cfg), qcfg)


def init_kv_cache(batch: int, max_len: int, cfg: ArchConfig, device,
                  window: Optional[int] = None,
                  kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A ``(batch, max_len)`` buffer per layer, or with ``window`` a ring
    of ``min(window, max_len)`` positions; ``kv_heads`` (default the
    config's) is a rank's head group under a mesh."""
    cap = min(window, max_len) if window else max_len
    kv, hd = kv_heads or cfg.num_kv_heads, cfg.head_dim
    shape = (batch, cap, kv, hd)
    idx = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.kv_cache_bits:
        sshape = (batch, cap, kv, 1)
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
                        cfg: ArchConfig, device,
                        kv_heads: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """``num_pages + 1`` pages: the last is the null page that unused
    block-table entries point at; ``kv_heads`` as in
    :func:`init_kv_cache`."""
    kv, hd = kv_heads or cfg.num_kv_heads, cfg.head_dim
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
    B, S = q.shape[:2]
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
    out = _attend_plain(q, k_att, v_att, q_abs, slot[None, :].expand(B, cap),
                        valid, cfg, None)
    cache["idx"] += S
    return out.to(q.dtype)


def _attend_plain(q, k_att, v_att, q_abs, abs_pos, valid, cfg: ArchConfig,
                  window: Optional[int]):
    """Plain softmax attention of ``q (B,S,h,hd)`` over the keys
    ``k_att/v_att (B,K,kv,hd)`` at absolute positions ``abs_pos (B,K)``;
    ``valid (B,K)`` marks keys that hold a position."""
    B, S, h, hd = q.shape
    rep = h // k_att.shape[2]
    kf = k_att.repeat_interleave(rep, dim=2).to(torch.float32)
    vf = v_att.repeat_interleave(rep, dim=2).to(torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kf) / math.sqrt(hd)
    logits = _softcap(logits, cfg.attn_logit_softcap)
    mask = valid[:, None, :] & (abs_pos[:, None, :] <= q_abs[:, :, None])
    if window:
        mask &= abs_pos[:, None, :] > (q_abs[:, :, None] - window)
    logits = torch.where(mask[:, None], logits,
                         torch.full((), -1e30, device=q.device))
    p_attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p_attn, vf)


def split_kv() -> bool:
    """Whether the active rules split a dense cache by position (the
    decode rules under a mesh whose ``kv_seq`` axes have more than one
    rank)."""
    return axis_shards("kv_seq") > 1


def _gather_heads(ts, group):
    """Every rank's head group of each of ``ts`` (B, S, heads, d),
    concatenated in rank order, in one all-gather."""
    B, S = ts[0].shape[:2]
    widths = [t.shape[2] for t in ts]
    both = collectives.gather_with_grad(torch.cat(ts, dim=2), group, dim=2)
    m = both.shape[2] // sum(widths)
    both = both.reshape(B, S, m, sum(widths), -1)
    out, lo = [], 0
    for w in widths:
        out.append(both[:, :, :, lo:lo + w].reshape(B, S, m * w, -1))
        lo += w
    return out


def _block_write(cache, store, cols: torch.Tensor, lo: int) -> None:
    """Write ``store``'s ``(B, S, ...)`` values at the global positions
    ``cols (B, S)`` into this rank's block of ``L`` positions starting at
    ``lo``; positions outside the block leave it as it was. The targets
    are ``cols - lo`` modulo L, distinct for the S <= L consecutive
    positions of a row, and a position outside the block writes back the
    value it read, so no write depends on the scatter's order and no
    host sync decides where to write."""
    B, S = cols.shape
    L = cache[store[0][0]].shape[1]
    if S > L:
        raise ValueError(f"{S} new positions exceed a block of {L}")
    rows = torch.arange(B, device=cols.device)[:, None]
    lc = torch.remainder(cols - lo, L)
    inside = (cols >= lo) & (cols < lo + L)
    for key, new in store:
        buf = cache[key]
        keep = inside.reshape((B, S) + (1,) * (buf.dim() - 2))
        buf[rows, lc] = torch.where(keep, new.to(buf.dtype), buf[rows, lc])


def _softmax_partial(logits: torch.Tensor, mask: torch.Tensor):
    """``(m, p, l)`` of masked f32 logits over their last dim: the max of
    the valid logits (-inf where none is valid), ``exp(logit - m)`` (0
    where masked) and its sum (0 where none is valid)."""
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m,
                                       torch.zeros_like(m))[..., None])
    return m, p, p.sum(dim=-1)


def partial_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_pos: torch.Tensor, q_abs: torch.Tensor,
                   cfg: ArchConfig, chunk: int = SPLIT_CHUNK):
    """Attention of ``q (B, S, h, hd)`` over one block of keys ``k, v (B,
    L, kv, hd)`` at the absolute positions ``k_pos (L,)``, a query at
    ``q_abs (B, S)`` seeing the keys at or before it. GQA grouped: q is
    read as ``(B, S, kv, rep, hd)`` (query head ``j·rep + r`` on KV head
    j), with no repeat of the keys; the block is cast to f32 ``chunk``
    positions at a time. Returns the unnormalised partial ``(m, l, o)``:
    per query head the max logit ``m (B, kv, rep, S)`` (-inf where the
    block holds no valid key), ``l = Σ exp(logit - m)`` and ``o = Σ
    exp(logit - m)·v (B, kv, rep, S, hd)``, all f32."""
    B, S, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, S, kv, h // kv, hd)
    logits = torch.cat([torch.einsum(
        "bskrd,bckd->bkrsc", qg, k[:, c:c + chunk].to(torch.float32))
        for c in range(0, L, chunk)], dim=-1) / math.sqrt(hd)
    logits = _softcap(logits, cfg.attn_logit_softcap)
    mask = (k_pos[None, None, :] <= q_abs[:, :, None])[:, None, None]
    m, p, l = _softmax_partial(logits, mask)
    o = sum(torch.einsum("bkrsc,bckd->bkrsd", p[..., c:c + chunk],
                         v[:, c:c + chunk].to(torch.float32))
            for c in range(0, L, chunk))
    return m, l, o


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   group) -> torch.Tensor:
    """The attention output from every rank's partial ``(m, l, o)``
    (:func:`partial_attend`) over ``group``: the maxima MAX-reduced, each
    rank's sums and outputs rescaled by ``exp(m - M)`` (exactly 0 for a
    block with no valid key, whose ``m`` is -inf), then one SUM reduce of
    both in f32, and ``o / l`` (0 where no rank held a valid key). With no
    group this normalises the one block."""
    M = collectives.max_reduce(m, group)
    a = torch.exp(m - torch.where(torch.isfinite(M), M, torch.zeros_like(M)))
    l, o = l * a, o * a[..., None]
    if collectives.group_size(group) > 1:
        n = l.numel()
        both = collectives.sum_reduce(torch.cat([l.reshape(-1),
                                                 o.reshape(-1)]), group)
        l, o = both[:n].reshape(l.shape), both[n:].reshape(o.shape)
    return torch.where(l[..., None] > 0, o / torch.where(
        l > 0, l, torch.ones_like(l))[..., None], torch.zeros_like(o))


def _split_decode_attend(q, k_new, v_new, cache, cfg: ArchConfig):
    """:func:`_decode_attend` over a cache split by position: this rank
    holds positions ``[lo, lo + L)`` of every row (block ``axis_index(
    "kv_seq")``) and every KV head, and ``q``, ``k_new``, ``v_new`` hold
    every head. The S new positions go at the whole buffer's clamped
    cursor, as one device writes them, on the rank whose block holds
    each; every rank attends its block, and the partials merge over the
    ``kv_seq`` group. ``idx`` is the whole row's cursor on every rank."""
    B, S, h, hd = q.shape
    idx = cache["idx"].long()
    L = cache["k"].shape[1]
    lo = axis_index("kv_seq") * L
    cap = L * axis_shards("kv_seq")
    ar = torch.arange(S, device=q.device)
    q_abs = idx[:, None] + ar                                   # (B, S)
    cols = torch.clamp(idx, max=cap - S)[:, None] + ar
    if cfg.kv_cache_bits:
        pk, sk = _kv_encode(k_new, cfg)
        pv, sv = _kv_encode(v_new, cfg)
        store = (("k", pk), ("v", pv), ("k_scale", sk), ("v_scale", sv))
    else:
        store = (("k", k_new), ("v", v_new))
    _block_write(cache, store, cols, lo)
    if cfg.kv_cache_bits:
        k_att = _kv_decode(cache["k"], cache["k_scale"], cfg)
        v_att = _kv_decode(cache["v"], cache["v_scale"], cfg)
    else:
        k_att, v_att = cache["k"], cache["v"]
    k_pos = lo + torch.arange(L, device=q.device)
    m, l, o = partial_attend(q, k_att, v_att, k_pos, q_abs, cfg)
    out = merge_partials(m, l, o, axis_group("kv_seq"))  # (B,kv,rep,S,hd)
    cache["idx"] += S
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, h, hd).to(q.dtype)


def _ring_attend(q, k_new, v_new, cache, cfg: ArchConfig, window: int):
    """A sliding-window layer's append: attend over the old ring's
    contents and the S new keys, then write the new keys into the ring.
    Inserting first would evict keys that earlier queries of the call
    still see. Ring slot ``s`` holds the position ``p = s (mod cap)`` with
    ``p <= idx - 1``; the last ``min(S, cap)`` new positions are written
    (with ``S >= cap`` the call's own tail fills the whole ring)."""
    B, S = q.shape[:2]
    idx = cache["idx"].long()
    cap = cache["k"].shape[1]
    ar = torch.arange(S, device=q.device)
    q_abs = idx[:, None] + ar                                   # (B, S)
    slot = torch.arange(cap, device=q.device)
    last_prev = idx[:, None] - 1
    abs_prev = last_prev - torch.remainder(last_prev - slot[None, :], cap)
    quant = bool(cfg.kv_cache_bits)
    if quant:
        pk, sk = _kv_encode(k_new, cfg)
        pv, sv = _kv_encode(v_new, cfg)
        k_old = _kv_decode(cache["k"], cache["k_scale"], cfg)
        v_old = _kv_decode(cache["v"], cache["v_scale"], cfg)
        store = (("k", pk), ("v", pv), ("k_scale", sk), ("v_scale", sv))
    else:
        k_old, v_old = cache["k"], cache["v"]
        store = (("k", k_new), ("v", v_new))
    k_att = torch.cat([k_old, k_new.to(k_old.dtype)], dim=1)
    v_att = torch.cat([v_old, v_new.to(v_old.dtype)], dim=1)
    abs_pos = torch.cat([abs_prev, q_abs], dim=1)               # (B, cap+S)
    valid = torch.cat([abs_prev >= 0,
                       torch.ones((B, S), dtype=torch.bool,
                                  device=q.device)], dim=1)
    out = _attend_plain(q, k_att, v_att, q_abs, abs_pos, valid, cfg, window)
    m = min(S, cap)
    rows = torch.arange(B, device=q.device)[:, None]
    cols = torch.remainder(idx[:, None] + (S - m)
                           + torch.arange(m, device=q.device), cap)
    for key, new in store:
        cache[key][rows, cols] = new[:, S - m:].to(cache[key].dtype)
    cache["idx"] += S
    return out.to(q.dtype)


def _last_writer(target: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """True at each kept write that no later kept write (in row-major
    order) sends to the same ``target`` slot. Idle rows and prefill pads
    write through block-table entries that all name the null page, so
    one call can send several writes to one slot of it; a card's scatter
    applies such duplicates in no fixed order, and the data replicas of
    a mesh then hold different null pages (ROADMAP H20). Keeping only the
    last writer gives the CPU's scatter order on every device, and the
    JAX package's on the CPU. A stable sort, no host sync."""
    n = target.shape[0]
    ar = torch.arange(n, device=target.device)
    t = torch.where(keep, target.long(), -1 - ar)      # dropped: distinct
    srt, order = torch.sort(t, stable=True)
    last = torch.ones_like(keep)
    last[:-1] = srt[1:] != srt[:-1]
    out = torch.empty_like(keep)
    out[order] = last
    return out


def _paged_attend(q, k_new, v_new, cache, cfg: ArchConfig,
                  block_table: torch.Tensor):
    """Scatter the S new positions into the row's pages (positions past
    the table's span are dropped), then attend through K5. Under a mesh
    ``q`` and the pools hold this rank's head group and the one block
    table is replicated: K5 attends the group's heads as one device
    would (the JAX package's ``_paged_attend_sharded``), and the caller
    gathers the heads."""
    B, S, h, hd = q.shape
    pool_k = cache["kp"]
    page = pool_k.shape[1]
    mp = block_table.shape[1]
    idx = cache["idx"].long()
    pos = idx[:, None] + torch.arange(S, device=q.device)       # (B, S)
    pg = torch.gather(block_table.long(), 1, torch.clamp(pos // page, 0,
                                                         mp - 1))
    keep = (pos < mp * page).reshape(-1)
    keep &= _last_writer(pg.reshape(-1) * page + (pos % page).reshape(-1),
                         keep)
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


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)


def mla_leaves(cfg: ArchConfig):
    """``(name, spec)`` of ``mla_init``'s leaves in the JAX package's
    order: ``("dense", d_in, d_out)`` weights in the compute dtype and
    ``("zeros", n)`` f32 norm gains."""
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rpe, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return [("q_down", ("dense", d, qr)), ("q_norm", ("zeros", qr)),
            ("q_up", ("dense", qr, h * (nope + rpe))),
            ("kv_down", ("dense", d, kvr + rpe)), ("kv_norm", ("zeros", kvr)),
            ("kv_up", ("dense", kvr, h * (nope + vd))),
            ("wo", ("dense", h * vd, d))]


def mla_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig,
              qcfg: Optional[QuantConfig], *, positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Multi-head latent attention over ``x`` (B, S, D). The query goes
    through the rank ``q_lora_rank`` bottleneck (``q_down``, RMSNorm,
    ``q_up``), the keys and values through the latent ``c_kv`` (width
    ``kv_lora_rank``, RMSNorm) beside one rope key shared by the heads.
    Without ``cache`` (training) the latent is expanded by ``kv_up`` and
    the heads attend by :func:`flash_attention` (qk width nope + rope, v
    width ``v_head_dim``); with one the new latents and rope keys are
    written at each row's cursor and attended in the absorbed form. Every
    2-D projection goes through ``qeinsum``; ``kv_up`` is decoded in the
    absorbed form, as in the JAX package.

    Under a mesh that shards ``qkv_out``, ``q_up`` and ``kv_up`` are this
    rank's head blocks: the rank attends its own heads against the
    replicated latent cache (every head reads the one latent) and the
    heads are all-gathered before the replicated ``wo``."""
    B, S, _ = x.shape
    nope, rpe, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    grp = axis_group("qkv_out")
    xs = act_stat(x, qcfg)        # one reduce for q_down and kv_down
    ql = qeinsum("bsd,dr->bsr", x, dense_of(p["q_down"], cfg), qcfg,
                 x_stat=xs)
    ql = rms_norm(ql, p["q_norm"], cfg.norm_eps)
    q = qeinsum("bsr,re->bse", ql, dense_of(p["q_up"], cfg), qcfg)
    h = q.shape[-1] // (nope + rpe)                  # this rank's heads
    q = q.reshape(B, S, h, nope + rpe)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kvd = qeinsum("bsd,dr->bsr", x, dense_of(p["kv_down"], cfg), qcfg,
                  x_stat=xs)
    c_kv = rms_norm(kvd[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = kvd[..., kvr:]
    rot = rope(positions, rpe, cfg.rope_theta)
    if rot.dim() == 3:
        rot = rot[None]
    q_rope = apply_rope(q_rope, rot)
    k_rope = apply_rope(k_rope[:, :, None, :], rot)[:, :, 0, :]
    if cache is None:
        kv = qeinsum("bsr,re->bse", c_kv, dense_of(p["kv_up"], cfg), qcfg)
        kv = kv.reshape(B, S, h, nope + vd)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, rpe)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        qq, k, v = _qa((qq, k, v), cfg, qcfg)
        out = flash_attention(qq, k, v)
    elif split_kv():
        out = _mla_split_decode(q_nope, q_rope, c_kv, k_rope,
                                decoded_of(p["kv_up"], cfg), cache, cfg, grp)
    else:
        out = _mla_decode(q_nope, q_rope, c_kv, k_rope,
                          decoded_of(p["kv_up"], cfg), cache, cfg)
    out = collectives.gather_with_grad(out, grp, dim=2)
    out = out.reshape(B, S, out.shape[2] * vd)
    return qeinsum("bse,ed->bsd", out, dense_of(p["wo"], cfg), qcfg)


def init_mla_cache(batch: int, max_len: int, cfg: ArchConfig,
                   device) -> Dict[str, torch.Tensor]:
    """The latent cache of one MLA layer: ``c_kv (batch, max_len,
    kv_lora_rank)`` and ``k_rope (batch, max_len, qk_rope_dim)`` in the
    compute dtype, and a per-row cursor ``idx``."""
    dt = cfg.compute_dtype
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dt, device=device),
            "idx": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _mla_decode(q_nope, q_rope, c_kv_new, k_rope_new, kv_up, cache,
                cfg: ArchConfig):
    """The absorbed form: write the S new latents and rope keys at each
    row's cursor (clamped to the buffer, as a dynamic slice update
    clamps), fold ``kv_up``'s key half into the query and its value half
    into the context, all in f32; position ``p`` of a row is seen by its
    queries at ``idx + s >= p``, as in the JAX package."""
    B, S, h, nope = q_nope.shape
    kvr, vd = cfg.kv_lora_rank, cfg.v_head_dim
    idx = cache["idx"].long()
    cap = cache["c_kv"].shape[1]
    ar = torch.arange(S, device=q_nope.device)
    rows = torch.arange(B, device=q_nope.device)[:, None]
    cols = torch.clamp(idx, max=cap - S)[:, None] + ar
    cache["c_kv"][rows, cols] = c_kv_new.to(cache["c_kv"].dtype)
    cache["k_rope"][rows, cols] = k_rope_new.to(cache["k_rope"].dtype)
    ck = cache["c_kv"].to(torch.float32)
    kr = cache["k_rope"].to(torch.float32)
    w = kv_up.reshape(kvr, h, nope + vd).to(torch.float32)
    w_k, w_v = w[..., :nope], w[..., nope:]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(torch.float32), w_k)
    logits = (torch.einsum("bshr,bkr->bhsk", q_abs, ck)
              + torch.einsum("bshr,bkr->bhsk", q_rope.to(torch.float32), kr))
    logits = logits / math.sqrt(nope + cfg.qk_rope_dim)
    slot = torch.arange(cap, device=q_nope.device)
    q_pos = idx[:, None] + ar                                   # (B, S)
    mask = slot[None, None, :] <= q_pos[:, :, None]             # (B, S, cap)
    logits = torch.where(mask[:, None], logits,
                         torch.full((), -1e30, device=q_nope.device))
    p_attn = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhsk,bkr->bshr", p_attn, ck)
    out = torch.einsum("bshr,rhv->bshv", ctx, w_v)
    cache["idx"] += S
    return out.to(q_nope.dtype)


def _mla_split_decode(q_nope, q_rope, c_kv_new, k_rope_new, kv_up, cache,
                      cfg: ArchConfig, group):
    """:func:`_mla_decode` over a latent cache split by position (this
    rank's block ``[lo, lo + L)``). The rank folds ``kv_up``'s key half
    into its own heads' queries, gathers the absorbed queries and rope
    queries of every head over ``group`` (the head groups; none where
    ``kv_up`` is whole), attends its block for every head against the
    one latent (a partial of :func:`partial_attend`'s kind, GQA with one
    KV head), merges the latent contexts over the ``kv_seq`` group, and
    keeps its own heads' contexts for ``kv_up``'s value half; the caller
    gathers the heads before ``wo``."""
    B, S, hl, nope = q_nope.shape
    kvr, vd, rpe = cfg.kv_lora_rank, cfg.v_head_dim, cfg.qk_rope_dim
    idx = cache["idx"].long()
    L = cache["c_kv"].shape[1]
    lo = axis_index("kv_seq") * L
    cap = L * axis_shards("kv_seq")
    ar = torch.arange(S, device=q_nope.device)
    cols = torch.clamp(idx, max=cap - S)[:, None] + ar
    _block_write(cache, (("c_kv", c_kv_new), ("k_rope", k_rope_new)), cols,
                 lo)
    w = kv_up.reshape(kvr, hl, nope + vd).to(torch.float32)
    w_k, w_v = w[..., :nope], w[..., nope:]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(torch.float32), w_k)
    qa = torch.cat([q_abs, q_rope.to(torch.float32)], dim=-1)
    if group is not None:
        qa = _gather_heads((qa,), group)[0]
    h = qa.shape[2]
    qa = qa.reshape(B, S, 1, h, kvr + rpe)
    ck, kr = cache["c_kv"], cache["k_rope"]
    chunk = SPLIT_CHUNK
    logits = torch.cat([
        torch.einsum("bskhr,bcr->bkhsc", qa[..., :kvr],
                     ck[:, c:c + chunk].to(torch.float32))
        + torch.einsum("bskhr,bcr->bkhsc", qa[..., kvr:],
                       kr[:, c:c + chunk].to(torch.float32))
        for c in range(0, L, chunk)], dim=-1) / math.sqrt(nope + rpe)
    k_pos = lo + torch.arange(L, device=q_nope.device)
    q_pos = idx[:, None] + ar
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None, None]
    m, p, l = _softmax_partial(logits, mask)
    o = sum(torch.einsum("bkhsc,bcr->bkhsr", p[..., c:c + chunk],
                         ck[:, c:c + chunk].to(torch.float32))
            for c in range(0, L, chunk))
    ctx = merge_partials(m, l, o, axis_group("kv_seq"))  # (B,1,h,S,kvr)
    ctx = ctx[:, 0].transpose(1, 2)                       # (B,S,h,kvr)
    i = axis_index("qkv_out") if hl < h else 0
    ctx = ctx[:, :, i * hl:(i + 1) * hl]
    out = torch.einsum("bshr,rhv->bshv", ctx, w_v)
    cache["idx"] += S
    return out.to(q_nope.dtype)
