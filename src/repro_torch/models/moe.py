"""Mixture of experts: a top-k router, routed experts with a capacity,
shared experts, as ``repro.models.moe``.

Two dispatch paths, as in the JAX package:

* ``sort``: the (token, k) assignments are ranked within their expert by
  a stable argsort over expert ids and gathered into a per-expert buffer
  of ``C = max(int(capacity_factor · T · K / E), 1)`` slots
  (``_group_routing_maps``); assignments past an expert's capacity drop.
  The expert FFNs run over the ``(G, E, C, D)`` buffer and the outputs
  are gathered back, weighted by their gates. The gathers' gradients are
  gathers through the dual map (:class:`_DispatchGather`,
  :class:`_CombineGather`), summed over k in order, as JAX's custom VJPs
  are. ``G`` is the size of the active mesh's data axes (1 without a
  mesh), as JAX's ``_dp_groups``, with the capacity taken per group.
* ``dense_ref``: every token through every expert, a masked combine;
  the oracle of the sort path at small sizes.

The router stays f32 (its weight decoded to the compute dtype and
promoted); the expert GEMMs quantize as dense MLPs do, on the decoded
expert stacks (the JAX package runs them outside any Pallas kernel), and
the shared experts' 2-D weights route through K1 and K2.

Capacity couples the rows of a call: at a decode step's few tokens C is
1, so idle slots and bucket padding take capacity as real tokens do (in
both packages). Where no autograd graph is recorded (serving), the
expert stacks are decoded and multiplied a chunk of experts at a time,
with Q_A and Q_W's scales taken over the whole buffer and stack, so the
result is the whole stack's and only one chunk's dense copy is alive.

Expert parallelism (a mesh whose serving rules shard ``experts``): the
router runs replicated in f32 and every rank builds the same ``(G, E, C,
D)`` buffer; each rank runs its own contiguous block of experts through
the chunked path, with Q_A's scale of the buffer taken over the whole
buffer, Q_W's stack scales and the hidden Q_A scale max-reduced over the
ranks, and the skipped-expert test decided on the global maximum; the
expert outputs are all-gathered and combined in the single device's
order. Only maxima and concatenations cross ranks (where JAX's GSPMD
may sum the experts' outputs), so the result is one device's bit for
bit; each expert's einsum takes a fixed batch of experts
(:func:`_experts_einsum`), so a rank's product is one card's.

Data parallelism (a training mesh that splits ``batch``): a rank holds
one data shard's tokens, which are exactly one of the reference's
dispatch groups, so :func:`_dp_groups` counts the groups its own rows
hold (one). The balance loss enters as the rank's share: the route
counts are SUM-reduced over the data group and the probabilities summed
over the rank's tokens divide by the global token count. Q_A's scales
of the expert buffers are the global batch's, and the no-grad path's
skip test is decided on the maximum over the data group (jointly with
the expert group), so every rank issues the same collectives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.lns import (LNSFormat, compute_scale, is_lns_weight,
                                  lns_decode_packed, lns_quantize,
                                  pow2_scale)
from repro_torch.core.quantizer import QuantConfig, qeinsum, quantize
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (axis_group, axis_shards,
                                              batch_group, current_mesh,
                                              joint_group)
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import ACT_FNS, decoded_of, dense_of

__all__ = ["moe_leaves", "moe_apply", "routing", "dropped"]

# the no-grad expert path decodes this many weight elements at a time
# (deepseek-v3's and kimi-k2's 7168 x 2048 experts: 9 a chunk)
_EXPERT_CHUNK_ELEMS = 1 << 27


def moe_leaves(cfg: ArchConfig):
    """``(name, spec)`` of ``moe_init``'s leaves in the JAX package's
    order: the f32 router ``("dense", d, E, f32)``, the expert stacks
    ``("experts", d_in, d_out, std)`` (normals, not truncated, in the
    compute dtype), then the shared experts' ``("dense", ...)`` weights
    under ``shared/``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = cfg.compute_dtype
    out = [("router", ("dense", d, e, torch.float32)),
           ("w_up", ("experts", d, f, d ** -0.5)),
           ("w_gate", ("experts", d, f, d ** -0.5)),
           ("w_down", ("experts", f, d, f ** -0.5))]
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        out += [("shared/up", ("dense", d, fs, dt)),
                ("shared/gate", ("dense", d, fs, dt)),
                ("shared/down", ("dense", fs, d, dt))]
    return out


def _route_counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Routes an expert: ``bincount(ids, minlength=E)`` for ids below E,
    int64, as a scatter-add (which a ``meta`` tensor can run too)."""
    ids = ids.long()
    return torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _router(p, x: torch.Tensor, cfg: ArchConfig):
    """Top-k routing: ``(gates (T, K), expert ids (T, K), aux loss)``. The
    logits are f32; the top k is a stable descending sort, the lower
    expert first on a tie (``lax.top_k``'s order); the Switch-style
    balance loss counts the routes with a bincount. Under a
    data-parallel mesh the loss is this rank's share: the route counts
    are the global batch's and the mean probability sums this rank's
    tokens over the global count, so the shares sum to the one-device
    ``E · Σ me · ce``."""
    T = x.shape[0] * x.shape[1]
    E, K = cfg.num_experts, cfg.experts_per_token
    w = decoded_of(p["router"], cfg).to(torch.float32)
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), w)
    probs = torch.softmax(logits, dim=-1).reshape(T, E)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    counts = _route_counts(top_i.reshape(-1), E).to(torch.float32)
    group = batch_group()
    if group is None:
        me = torch.mean(probs, dim=0)
        ce = counts / (T * K)
    else:
        t_all = T * collectives.group_size(group)
        me = torch.sum(probs, dim=0) / t_all
        ce = collectives.sum_reduce(counts, group) / (t_all * K)
    aux = E * torch.sum(me * ce)
    return top_p, top_i, aux


def _records_grad(x: torch.Tensor, ws) -> bool:
    """Would autograd record this call (an input or a weight's ``delta``
    that needs a gradient)?"""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    for w in ws:
        t = w.delta if is_lns_weight(w) else w
        if t is not None and t.requires_grad:
            return True
    return False


def _expert_ffn(p, xe: torch.Tensor, cfg: ArchConfig,
                qcfg: Optional[QuantConfig]) -> torch.Tensor:
    """``xe (..., E, C, D)`` tokens grouped by expert -> the same shape:
    ``down(act(gate(x)) * up(x))`` with each expert's own weights, the
    grouped ``(G, E, C, D)`` buffer or the ``(E, T, D)`` of
    ``_dense_ref``. Without a graph to record, a chunk of experts at a
    time (:func:`_expert_ffn_chunked`)."""
    ws = (p["w_up"], p["w_gate"], p["w_down"])
    grp = axis_group("experts")
    if grp is not None:
        if _records_grad(xe, ws) or not _chunkable(qcfg):
            raise NotImplementedError(
                "expert parallelism serves only (no graph to record, an "
                "LNS or no Q_W)")
        return _expert_ffn_parallel(p, xe, cfg, qcfg, grp)
    if not _records_grad(xe, ws) and _chunkable(qcfg):
        return _expert_ffn_chunked(p, xe, cfg, qcfg)
    return _expert_ffn_whole(p, xe, cfg, qcfg)


def _expert_ffn_parallel(p, xe, cfg: ArchConfig, qcfg, group):
    """:func:`_expert_ffn_chunked` over this rank's contiguous block of
    experts (its shard of the stacks), then the ranks' outputs gathered
    along the expert axis. Q_A's scale of the buffer is the whole
    buffer's (every rank holds all of it); the scales that only the
    whole stack or every expert's rows fix are max-reduced in the chunked
    path over ``group``."""
    import torch.distributed as dist
    quant = qcfg is not None and qcfg.is_quantized
    a_fmt = qcfg.act if quant else None
    if a_fmt is not None and not (isinstance(a_fmt, LNSFormat)
                                  and qcfg.act_scale_axis is None):
        raise NotImplementedError("expert parallelism needs an LNS Q_A "
                                  "per tensor (or none)")
    e_ax = xe.dim() - 3
    n = p["w_up"].shape[0]
    r = dist.get_rank(group)
    x_scale = (collectives.max_reduce(compute_scale(xe), batch_group())
               if a_fmt is not None else None)
    y = _expert_ffn_chunked(p, xe.narrow(e_ax, r * n, n), cfg, qcfg,
                            group=group, x_scale=x_scale)
    return collectives.gather_with_grad(y, group, dim=e_ax)


def _expert_ffn_whole(p, xe: torch.Tensor, cfg: ArchConfig, qcfg):
    """The whole stacks at once, as the JAX package computes them: each
    decoded to the compute dtype (``dense_of``) and taken by ``qeinsum``'s
    fake-quant leg, whose Q_E sees the whole output's gradient."""
    act = ACT_FNS[cfg.act_fn]
    w_up, w_gate, w_down = (dense_of(p[k], cfg)
                            for k in ("w_up", "w_gate", "w_down"))
    g = "g" if xe.dim() == 4 else ""
    up = qeinsum(f"{g}ecd,edf->{g}ecf", xe, w_up, qcfg)
    gate = qeinsum(f"{g}ecd,edf->{g}ecf", xe, w_gate, qcfg)
    return qeinsum(f"{g}ecf,efd->{g}ecd", act(gate) * up, w_down, qcfg)


def _chunkable(qcfg: Optional[QuantConfig]) -> bool:
    """The chunked path computes the fake-quant leg of ``qeinsum`` (an
    LNS Q_W per tensor or per output channel, any Q_A), not the
    conversion-approximation simulation or a miniature-float Q_W."""
    if qcfg is None or not qcfg.is_quantized:
        return True
    if qcfg.approx_lut is not None:
        return False
    return qcfg.weight is None or (
        isinstance(qcfg.weight, LNSFormat)
        and qcfg.weight_scale_axis in (None, -1, 2))


def _expert_ffn_chunked(p, xe, cfg: ArchConfig, qcfg, group=None,
                        x_scale=None):
    """:func:`_expert_ffn` with no graph: Q_A over the whole buffer (as
    ``qeinsum`` takes it), then each expert stack decoded and multiplied
    a chunk of experts at a time under Q_W's scale over the whole stack;
    the quantizers are elementwise under those scales and each expert's
    product is its own.

    Only the experts with a nonzero input row are computed (at a decode
    step at most T·K of them); the others' rows are zero. The combine
    reads no row of theirs (it reads filled slots, and a dropped
    assignment's clipped slot times a zero gate), but under an LNS Q_A
    their zero rows encode as its smallest code, and those rows join the
    per-tensor Q_A scale of the down projection's input. That scale is
    the computed rows' wherever their largest magnitude passes a bound on
    the skipped rows' (:func:`_skipped_bound`), and every expert is
    computed where it does not: the rows the combine reads are the whole
    stack's, bit for bit.

    Under expert parallelism ``xe`` holds this rank's experts, ``x_scale``
    is the whole buffer's Q_A scale, and ``group`` max-reduces Q_W's stack
    scales, the computed rows' maximum that the skip test reads (a rank
    that computed every expert of its own contributes rows the bound
    covers, so the test decides as one device does) and the hidden Q_A
    scale.

    Under a data-parallel mesh Q_A's scales (the buffer's and the
    hidden one) and the skip test's maximum are taken jointly over the
    data group and the expert group (:func:`joint_group`), and the
    maximum is reduced on every rank whether or not it skipped experts,
    so every rank issues the same collectives."""
    act = ACT_FNS[cfg.act_fn]
    quant = qcfg is not None and qcfg.is_quantized
    a_fmt = qcfg.act if quant else None
    a_ax = qcfg.act_scale_axis if quant else None
    w_fmt = qcfg.weight if quant else None
    g = "g" if xe.dim() == 4 else ""
    e_ax = xe.dim() - 3
    E = xe.shape[e_ax]
    lns_a = isinstance(a_fmt, LNSFormat) and a_ax is None
    joint = joint_group("batch", "experts") if group is not None else \
        batch_group()
    if lns_a and x_scale is None:
        x_scale = collectives.max_reduce(compute_scale(xe), batch_group())
    xq = (lns_quantize(xe, a_fmt, scale=x_scale) if lns_a
          else quantize(xe, a_fmt, a_ax))
    sel = None
    # on ``meta`` (a dry run) which experts got rows is unknown: every
    # expert is computed, the most the step can cost
    if xe.device.type != "meta" and (
            a_fmt is None or (lns_a and w_fmt is not None)):
        rows = xe.ne(0).any(dim=-1).any(dim=-1)
        if rows.dim() == 2:
            rows = rows.any(dim=0)
        sel = torch.nonzero(rows).flatten().tolist()
        if len(sel) in (0, E):
            sel = None
    up, s_up = _experts_einsum(f"{g}ecd,edf->{g}ecf", xq, p["w_up"], cfg,
                               qcfg, w_fmt, sel, group=group)
    gate, s_gate = _experts_einsum(f"{g}ecd,edf->{g}ecf", xq, p["w_gate"],
                                   cfg, qcfg, w_fmt, sel, group=group)
    h = act(gate) * up
    if lns_a and (sel is not None or joint is not None):
        hmax = h.abs().amax() if h.numel() else h.new_zeros(())
        hmax = collectives.max_reduce(hmax.to(torch.float32), joint)
        if sel is not None and not float(hmax) > _skipped_bound(
                a_fmt, x_scale, xe.shape[-1], s_up, s_gate):
            sel = None
            up, _ = _experts_einsum(f"{g}ecd,edf->{g}ecf", xq, p["w_up"],
                                    cfg, qcfg, w_fmt, None, group=group)
            gate, _ = _experts_einsum(f"{g}ecd,edf->{g}ecf", xq,
                                      p["w_gate"], cfg, qcfg, w_fmt, None,
                                      group=group)
            h = act(gate) * up
    if joint is not None and lns_a:
        hq = lns_quantize(h, a_fmt, scale=collectives.max_reduce(
            compute_scale(h), joint))
    else:
        hq = quantize(h, a_fmt, a_ax)
    y, _ = _experts_einsum(f"{g}ecf,efd->{g}ecd", hq, p["w_down"], cfg, qcfg,
                           w_fmt, sel, x_sel=True, group=group)
    if sel is None:
        return y
    out = torch.zeros(xe.shape, dtype=y.dtype, device=y.device)
    out.index_copy_(e_ax, torch.tensor(sel, device=y.device), y)
    return out


def _skipped_bound(a_fmt: LNSFormat, x_scale, d_in: int, s_up, s_gate):
    """An upper bound on |act(gate)·up| over the rows of experts given no
    token: every element of such a row is Q_A's smallest code,
    ``2^(-max_code/γ)·S_x`` (rounded up by the compute dtype's ulp), and
    each Q_W weight is at most its channel's scale, so ``|up_f| <= d_in ·
    c0 · S_up_f`` and likewise the gate; the activations (SiLU, GELU,
    ReLU) are at most |gate|. A 10% slack covers the GEMMs' and the
    activation's roundings."""
    c0 = 2.0 ** (-a_fmt.max_code / a_fmt.gamma) * float(x_scale) * (
        1 + 2.0 ** -7)
    top = float((s_up.to(torch.float32) * s_gate.to(torch.float32)).amax())
    return 1.1 * (d_in * c0) ** 2 * top


def _expert_chunk(w, ids, dtype) -> torch.Tensor:
    """Experts ``ids`` (a slice or a list) of a stack, dense in
    ``dtype``."""
    if is_lns_weight(w):
        return w[ids].decode(dtype)
    return w[ids].to(dtype)


def _stack_scale(w, chunks, fmt_axis, dtype) -> torch.Tensor:
    """Q_W's power-of-two scale of the decoded ``(E, D_in, D_out)`` stack
    (per tensor, or per output channel), a chunk at a time. A packed
    leaf's largest magnitude along the contraction axis is its smallest
    code's decode (decoding is monotone), so its words are reduced, not
    decoded."""
    amax = None
    for ids in chunks:
        if is_lns_weight(w) and w.delta is None:
            fmt = w.fmt
            code = torch.bitwise_and(w.packed[ids], fmt.max_code).amin(
                dim=-2, keepdim=True)
            m = (lns_decode_packed(code, fmt, torch.float32)
                 * w.scale[ids]).to(dtype).to(torch.float32).abs()
        else:
            m = _expert_chunk(w, ids, dtype).to(torch.float32).abs().amax(
                dim=-2, keepdim=True)
        m = m.amax(dim=0, keepdim=True)
        if fmt_axis is None:
            m = m.amax()
        amax = m if amax is None else torch.maximum(amax, m)
    return pow2_scale(amax)


def _regrid_exact(w, w_fmt: LNSFormat, dtype) -> bool:
    """Can Q_W of this packed stack be taken on its words
    (:func:`_regrid_chunk`)? Its words must be on Q_W's grid already, γ
    small enough that the compute dtype's rounding of a decoded word
    moves its log2 by under half a code (bf16: 2^-8 relative, so γ <=
    64), every scale an exact power of two, and every decoded word a
    normal number (scale · 2^(-max_code/γ) >= 2^-126). One host read."""
    if not is_lns_weight(w) or w.delta is not None or w.fmt != w_fmt:
        return False
    if w.scale.device.type == "meta":
        # a dry run cannot read the scales: the decode-then-quantize path,
        # which computes more
        return False
    if w_fmt.gamma > (64 if dtype == torch.bfloat16 else 1 << 16):
        return False
    m, _ = torch.frexp(w.scale)
    floor = 2.0 ** (-126 + w_fmt.max_code / w_fmt.gamma)
    return bool(((m == 0.5) & (w.scale >= floor)).all())


def _regrid_chunk(w, ids, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Experts ``ids`` of a packed stack put on Q_W's grid at ``scale``
    straight from the words: ``lns_quantize(decode(w), fmt, scale)`` of
    a word of code c under the power-of-two scale s is the code
    ``clamp(c + γ·log2(S/s), 0, max_code)`` under S (the decode's
    rounding moves -log2·γ by under half a code where
    :func:`_regrid_exact` holds), decoded as ``lns_decode`` decodes,
    with the word's sign. Equal to the decode-then-quantize path, bit for
    bit, with one integer pass in place of the encode."""
    fmt = w.fmt
    words = w.packed[ids]
    shift = (torch.frexp(scale).exponent
             - torch.frexp(w.scale[ids]).exponent) * fmt.gamma
    code = torch.bitwise_and(words, fmt.max_code).to(torch.int32) + shift
    mag = torch.exp2(-code.clamp_(0, fmt.max_code).to(torch.float32)
                     / fmt.gamma)
    neg = torch.bitwise_right_shift(words, fmt.bits - 1).to(torch.bool)
    return (torch.where(neg, -mag, mag) * scale).to(dtype)


def _experts_einsum(eq: str, xq: torch.Tensor, w, cfg: ArchConfig, qcfg,
                    w_fmt, sel=None, x_sel: bool = False, group=None):
    """``(einsum(eq, xq, Q_W(w)), Q_W's scale)`` over the expert axis a
    chunk at a time (``xq`` already on Q_A's grid), for the experts
    ``sel`` (a list: the result holds theirs, in order) or all; with
    ``x_sel`` ``xq`` holds the selected experts' rows only. Q_W's scale
    is the whole stack's (with ``group``, max-reduced over the ranks'
    shards of it).

    Every einsum takes ``min(n, cfg.num_experts)`` experts, a short
    chunk padded with zero experts: cuBLAS picks its batched kernel (and
    so its summation order) by the batch count, so an expert's product is
    then the same whichever experts share its chunk, one card's
    selection or a rank's under expert parallelism."""
    E, d_in, d_out = w.shape
    e_ax = eq.index("e")
    n = max(1, _EXPERT_CHUNK_ELEMS // (d_in * d_out))
    batch = min(n, cfg.num_experts)
    dt = cfg.compute_dtype
    scale = None
    if w_fmt is not None:
        scale = _stack_scale(w, [slice(e0, e0 + n) for e0 in range(0, E, n)],
                             qcfg.weight_scale_axis, dt)
        scale = collectives.max_reduce(scale, group)
    fast = scale is not None and _regrid_exact(w, w_fmt, dt)
    if sel is None:
        chunks = [slice(e0, min(e0 + n, E)) for e0 in range(0, E, n)]
    else:
        chunks = [sel[i:i + n] for i in range(0, len(sel), n)]
    outs, at = [], 0
    for ids in chunks:
        if fast:
            wc = _regrid_chunk(w, ids, scale, dt)
        else:
            wc = _expert_chunk(w, ids, dt)
            if scale is not None:
                wc = lns_quantize(wc, w_fmt, scale=scale)
        if isinstance(ids, slice):
            xc = xq[(slice(None),) * e_ax + (ids,)]
        elif x_sel:
            xc = xq.narrow(e_ax, at, len(ids))
            at += len(ids)
        else:
            xc = xq.index_select(e_ax, torch.tensor(ids, device=xq.device))
        k = wc.shape[0]
        wc = _pad_experts(wc.to(xq.dtype), 0, batch)
        outs.append(torch.einsum(eq, _pad_experts(xc, e_ax, batch), wc)
                    .narrow(e_ax, 0, k))
    y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=e_ax)
    return y, scale


def _pad_experts(t: torch.Tensor, ax: int, n: int) -> torch.Tensor:
    """``t`` with zero experts appended along ``ax`` up to ``n``."""
    k = t.shape[ax]
    if k >= n:
        return t
    shape = list(t.shape)
    shape[ax] = n - k
    return torch.cat([t, t.new_zeros(shape)], dim=ax)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig,
              qcfg: Optional[QuantConfig]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``(out (B, S, D), aux loss)``: the routed experts (``sort`` or
    ``dense_ref``) plus the shared experts, a gated MLP of width
    ``num_shared_experts * moe_d_ff`` on every token."""
    top_p, top_i, aux = _router(p, x, cfg)
    if cfg.moe_dispatch == "dense_ref":
        out = _dense_ref(p, x, top_p, top_i, cfg, qcfg)
    else:
        out = _sorted_dispatch(p, x, top_p, top_i, cfg, qcfg)
    if cfg.num_shared_experts:
        sp = p["shared"]
        act = ACT_FNS[cfg.act_fn]
        up = qeinsum("bsd,df->bsf", x, dense_of(sp["up"], cfg), qcfg)
        gate = qeinsum("bsd,df->bsf", x, dense_of(sp["gate"], cfg), qcfg)
        hid = collectives.gather_with_grad(act(gate) * up,
                                           axis_group("mlp"))
        out = out + qeinsum("bsf,fd->bsd", hid, dense_of(sp["down"], cfg),
                            qcfg)
    return out, aux


def _dense_ref(p, x, top_p, top_i, cfg: ArchConfig, qcfg):
    """The O(E) oracle: every token through every expert, combined with
    the gates in f32."""
    B, S, D = x.shape
    T, E = B * S, cfg.num_experts
    xe = x.reshape(1, T, D).expand(E, T, D)
    ye = _expert_ffn(p, xe, cfg, qcfg)                           # (E, T, D)
    w = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    w = w.scatter_add(1, top_i, top_p.to(torch.float32))
    return torch.einsum("etd,te->td", ye.to(torch.float32), w).reshape(
        B, S, D).to(x.dtype)


def _group_routing_maps(flat_e: torch.Tensor, gates: torch.Tensor, E: int,
                        C: int, K: int):
    """One group's index maps, as the JAX package builds them.

    Returns ``slot_src (E·C,)`` the source token of each expert-capacity
    slot, ``slot_fill (E·C,)`` whether it is occupied, ``inv (T, K)`` the
    slot of each (token, k) (``E·C`` where it dropped), ``gate_inv (T,
    K)`` the gate, zero where dropped, and ``slot_gate (E·C,)`` the gate
    of the slot's occupant (0 if unfilled, no gradient). The ranks come
    from a stable argsort; the slot maps are scatters into ``E·C + 1``
    slots whose last (every drop's target) is sliced off."""
    TK = flat_e.shape[0]
    dev = flat_e.device
    flat_e = flat_e.long()
    tok = torch.div(torch.arange(TK, device=dev), K, rounding_mode="floor")
    counts = _route_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    rank = torch.arange(TK, device=dev) - starts[e_sorted]
    keep = rank < C
    dst = torch.where(keep, e_sorted * C + torch.clamp(rank, 0, C - 1),
                      torch.full_like(rank, E * C))
    slot_src = torch.zeros((E * C + 1,), dtype=torch.int32, device=dev)
    slot_src[dst] = tok[order].to(torch.int32)
    slot_fill = torch.zeros((E * C + 1,), dtype=torch.bool, device=dev)
    slot_fill[dst] = keep
    kept = gates.detach()[order] * keep.to(gates.dtype)
    slot_gate = torch.zeros((E * C + 1,), dtype=gates.dtype, device=dev)
    slot_gate[dst] = kept
    inv = torch.zeros((TK,), dtype=torch.int32, device=dev)
    inv[order] = dst.to(torch.int32)
    keep_tok = torch.zeros((TK,), dtype=torch.bool, device=dev)
    keep_tok[order] = keep
    # gates[order] * keep scattered back through ``order`` (a
    # permutation): each token's own gate, zeroed where it dropped
    gate_inv = gates * keep_tok.to(gates.dtype)
    return (slot_src[:E * C], slot_fill[:E * C], inv.reshape(TK // K, K),
            gate_inv.reshape(TK // K, K), slot_gate[:E * C])


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[g, idx[g, m]]`` for ``a (G, N, D)``, ``idx (G, M)``, indices
    clipped into ``[0, N)`` (``take_along_axis(mode="clip")``)."""
    i = torch.clamp(idx.long(), 0, a.shape[1] - 1)
    return torch.gather(a, 1, i[..., None].expand(-1, -1, a.shape[-1]))


def _sum_k(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k t[:, :, k] * w[:, :, k]`` for ``t (G, T, K, D)``, ``w (G, T,
    K, 1)``, summed k = 0, 1, ... in order."""
    acc = t[:, :, 0] * w[:, :, 0]
    for k in range(1, t.shape[2]):
        acc = acc + t[:, :, k] * w[:, :, k]
    return acc


class _DispatchGather(torch.autograd.Function):
    """``xe[g, s] = xg[g, slot_src[g, s]]`` (0 where unfilled). The
    gradient uses the dual map, a gather: ``dxg[g, t] = sum_k dxe[g,
    inv[g, t, k]]`` over the kept k."""

    @staticmethod
    def forward(ctx, xg, slot_src, slot_fill, inv, keep):
        ctx.save_for_backward(inv, keep)
        xe = _take_rows(xg, slot_src)
        return torch.where(slot_fill[..., None], xe, torch.zeros_like(xe))

    @staticmethod
    def backward(ctx, dxe):
        inv, keep = ctx.saved_tensors
        G = inv.shape[0]
        d = _take_rows(dxe, inv.reshape(G, -1)).reshape(
            inv.shape + (dxe.shape[-1],))                       # (G, T, K, D)
        return (_sum_k(d, keep[..., None].to(d.dtype)), None, None, None,
                None)


class _CombineGather(torch.autograd.Function):
    """``out[g, t] = sum_k ye[g, inv[g, t, k]] · gate[g, t, k]``. The
    gradient w.r.t. ``ye`` uses the dual map, a gather: ``dye[g, s] =
    dout[g, slot_src[g, s]] · slot_gate[g, s]``; w.r.t. the gates, the
    taken rows against ``dout``."""

    @staticmethod
    def forward(ctx, ye, inv, gate, slot_src, slot_gate):
        ctx.save_for_backward(ye, inv, gate, slot_src, slot_gate)
        taken = _take_rows(ye, inv.reshape(inv.shape[0], -1)).reshape(
            inv.shape + (ye.shape[-1],))
        return _sum_k(taken, gate[..., None].to(taken.dtype))

    @staticmethod
    def backward(ctx, dout):
        ye, inv, gate, slot_src, slot_gate = ctx.saved_tensors
        dye = _take_rows(dout, slot_src) * slot_gate[..., None].to(
            dout.dtype)
        taken = _take_rows(ye, inv.reshape(inv.shape[0], -1)).reshape(
            inv.shape + (ye.shape[-1],))
        dgate = torch.sum(taken * dout[:, :, None, :].to(taken.dtype),
                          dim=-1)
        return dye, None, dgate.to(gate.dtype), None, None


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots an expert: ``max(int(capacity_factor · T · K / E), 1)``,
    evaluated left to right in floats as the JAX package does."""
    return max(int(cfg.capacity_factor * tokens * cfg.experts_per_token
                   / cfg.num_experts), 1)


def routing(top_i: torch.Tensor, top_p: torch.Tensor, cfg: ArchConfig,
            dtype=torch.float32):
    """The sort dispatch's maps of one call's routes (one group):
    ``(C, slot_src, slot_fill, inv, gate_inv, slot_gate)``."""
    T, K = top_i.shape
    C = _capacity(cfg, T)
    maps = _group_routing_maps(top_i.reshape(-1), top_p.reshape(-1).to(dtype),
                               cfg.num_experts, C, K)
    return (C,) + maps


def _dp_groups() -> int:
    """The dispatch groups this rank's rows hold: the size of the active
    mesh's data axes (``pod`` and ``data``) over the shards the rules
    split the batch into, 1 without a mesh. Under serving (the batch
    replicated) that is the data size, as JAX's ``_dp_groups``; under
    data parallelism a rank holds one data shard's tokens, which are one
    of the reference's groups, so 1."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return max(1, n // axis_shards("batch"))


def _sorted_dispatch(p, x, top_p, top_i, cfg: ArchConfig, qcfg):
    """The grouped sort dispatch: the T tokens split into ``G`` groups of
    ``Tg`` (:func:`_dp_groups`, or 1 where G does not divide T), capacity
    ``C = max(int(capacity_factor · Tg · K / E), 1)`` an expert in each
    group, the buffer ``(G, E, C, D)`` through the experts, gathered
    back."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.num_experts, cfg.experts_per_token
    G = _dp_groups()
    if T % G:
        G = 1
    Tg = T // G
    C = _capacity(cfg, Tg)
    eg = top_i.reshape(G, Tg * K)
    gg = top_p.reshape(G, Tg * K).to(x.dtype)
    maps = [_group_routing_maps(eg[i], gg[i], E, C, K) for i in range(G)]
    slot_src, slot_fill, inv, gate_inv, slot_gate = (
        torch.stack(t) for t in zip(*maps))
    keep = gate_inv.detach() != 0
    xe = _DispatchGather.apply(x.reshape(G, Tg, D), slot_src, slot_fill, inv,
                               keep)
    ye = _expert_ffn(p, xe.reshape(G, E, C, D), cfg, qcfg)
    out = _CombineGather.apply(ye.reshape(G, E * C, D), inv, gate_inv,
                               slot_src, slot_gate)
    return out.reshape(B, S, D).to(x.dtype)


def dropped(top_i: torch.Tensor, cfg: ArchConfig) -> int:
    """How many of a call's (token, k) assignments ``top_i (T, K)`` its
    capacity drops (each expert keeps its first C)."""
    C = _capacity(cfg, top_i.shape[0])
    counts = torch.bincount(top_i.reshape(-1).long(),
                            minlength=cfg.num_experts)
    return top_i.numel() - int(torch.clamp(counts, max=C).sum())
