"""RWKV6 (Finch) block: data-dependent decay linear attention, as
``repro.models.rwkv``.

Time-mix: per-channel decays ``w_t = exp(-exp(w0 + lora(x)))`` (the decay
depends on the token), bonus ``u``, receptance/key/value/gate projections
and the WKV recurrence

    out_t = r_t · (S_{t-1} + diag(u)·k_t^T v_t)
    S_t   = diag(w_t)·S_{t-1} + k_t^T v_t

in f32: chunk-parallel without a state (training), one step a position
with one (every prefill and decode step). Channel-mix is the squared-relu
RWKV FFN. The token-shift mixes are static learned coefficients, as in
the JAX package (its documented deviation from the reference
implementation's five dynamic LoRAs; the decay LoRA is kept).

Under a serving mesh the time mix is replicated (its projections are
``ssm_inner``, which the serving rules keep whole), so every rank runs
the whole WKV and holds the whole state; the channel mix is
column-parallel where ``d_ff`` divides the ``model`` axis: ``ck`` is the
rank's column block and the squared-ReLU hidden state is all-gathered
before the whole ``cv``, whose Q_A then sees the whole tensor.

The recurrence is plain torch: the JAX package computes it outside any
Pallas kernel. A state dict is updated **in place** (``copy_`` into the
engine's cache views).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantizer import QuantConfig, qeinsum
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import axis_group
from repro_torch.models.common import _DECAY_LORA, ArchConfig
from repro_torch.models.layers import decoded_of, dense_of

__all__ = ["rwkv_leaves", "rwkv_apply", "init_rwkv_state"]


def rwkv_leaves(cfg: ArchConfig):
    """``(name, spec)`` of ``rwkv_init``'s leaves in its order; a spec is
    ``("dense", d_in, d_out, dtype)`` (a truncated normal of std
    1/sqrt(d_in)) or ``("const", shape, value)`` (f32)."""
    d, f = cfg.d_model, cfg.d_ff
    h = d // cfg.ssm_head_dim
    dt, f32 = cfg.compute_dtype, torch.float32
    return [("mix", ("const", (5, d), 0.5)), ("w0", ("const", (d,), 0.0)),
            ("w_lora_a", ("dense", d, _DECAY_LORA, f32)),
            ("w_lora_b", ("const", (_DECAY_LORA, d), 0.0)),
            ("u", ("const", (d,), 0.0)),
            ("wr", ("dense", d, d, dt)), ("wk", ("dense", d, d, dt)),
            ("wv", ("dense", d, d, dt)), ("wg", ("dense", d, d, dt)),
            ("wo", ("dense", d, d, dt)),
            ("ln_x", ("const", (h, cfg.ssm_head_dim), 0.0)),
            ("mix_cm", ("const", (2, d), 0.5)),
            ("ck", ("dense", d, f, dt)), ("cv", ("dense", f, d, dt)),
            ("cr", ("dense", d, d, dt))]


def init_rwkv_state(batch: int, cfg: ArchConfig,
                    device) -> Dict[str, torch.Tensor]:
    d, p = cfg.d_model, cfg.ssm_head_dim
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"shift_tm": z(batch, d), "shift_cm": z(batch, d),
            "S": z(batch, d // p, p, p)}


def _shifted(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` before the first position."""
    pad = (torch.zeros_like(x[:, :1]) if prev is None
           else prev[:, None].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


def rwkv_apply(p: Dict[str, Any], x: torch.Tensor, x_cm: torch.Tensor,
               cfg: ArchConfig, qcfg: Optional[QuantConfig],
               state: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tm_out, cm_out)`` of the time-mix over ``x`` and the channel-mix
    over ``x_cm`` (both (B, S, D), pre-normed). With ``state`` the WKV
    runs one step a position from it and the state is updated in place."""
    B, S, D = x.shape
    hn, hd = D // cfg.ssm_head_dim, cfg.ssm_head_dim
    xs = _shifted(x, state["shift_tm"] if state is not None else None)
    mix = decoded_of(p["mix"], cfg)[:, None, None, :]          # (5,1,1,D)
    xr, xk, xv, xg, xw = [x + (xs - x) * mix[i] for i in range(5)]

    r = qeinsum("bsd,de->bse", xr, dense_of(p["wr"], cfg), qcfg)
    k = qeinsum("bsd,de->bse", xk, dense_of(p["wk"], cfg), qcfg)
    v = qeinsum("bsd,de->bse", xv, dense_of(p["wv"], cfg), qcfg)
    g = F.silu(qeinsum("bsd,de->bse", xg, dense_of(p["wg"], cfg), qcfg))
    # the decay LoRA in f32 (decoded leaves come in the compute dtype: f32
    # meets them as JAX's promotion does); the log decay is clipped so the
    # chunked form's exp(-lcum) stays finite
    f32 = torch.float32
    lora = torch.tanh(xw.to(f32) @ decoded_of(p["w_lora_a"], cfg).to(f32)) \
        @ decoded_of(p["w_lora_b"], cfg).to(f32)
    logw = -torch.exp(torch.clamp(p["w0"] + lora, -8.0, 1.25))

    rh = r.to(f32).reshape(B, S, hn, hd)
    kh = k.to(f32).reshape(B, S, hn, hd)
    vh = v.to(f32).reshape(B, S, hn, hd)
    wh = logw.reshape(B, S, hn, hd)
    uh = p["u"].reshape(hn, hd)
    if state is None:
        y, _ = _wkv_chunked(rh, kh, vh, wh, uh, cfg.rwkv_chunk)
    else:
        s_last = state["S"]
        ys = []
        for t in range(S):
            rt, kt, vt, wt = rh[:, t], kh[:, t], vh[:, t], wh[:, t]
            kc, vr = kt[..., None], vt[..., None, :]
            # JAX's order: (u k) v for the bonus
            att = s_last + uh[None, :, :, None] * kc * vr
            ys.append(torch.einsum("bhp,bhpq->bhq", rt, att))
            s_last = torch.exp(wt)[..., None] * s_last + kc * vr
        y = torch.stack(ys, dim=1)

    # per-head group norm (population variance), gate, output projection
    mean = y.mean(dim=-1, keepdim=True)
    c = y - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + 64e-5) * (1.0 + decoded_of(p["ln_x"], cfg))
    y = (y.reshape(B, S, D) * g.to(f32)).to(x.dtype)
    tm_out = qeinsum("bsd,de->bse", y, dense_of(p["wo"], cfg), qcfg)

    # channel mix
    xcs = _shifted(x_cm, state["shift_cm"] if state is not None else None)
    mixc = decoded_of(p["mix_cm"], cfg)[:, None, None, :]
    xck = x_cm + (xcs - x_cm) * mixc[0]
    xcr = x_cm + (xcs - x_cm) * mixc[1]
    kk = qeinsum("bsd,df->bsf", xck, dense_of(p["ck"], cfg), qcfg)
    kk = collectives.gather_with_grad(torch.square(F.relu(kk)),
                                      axis_group("mlp"))
    vv = qeinsum("bsf,fd->bsd", kk, dense_of(p["cv"], cfg), qcfg)
    rr = torch.sigmoid(qeinsum("bsd,de->bse", xcr, dense_of(p["cr"], cfg),
                               qcfg))
    if state is not None:
        state["S"].copy_(s_last)
        state["shift_tm"].copy_(x[:, -1])
        state["shift_cm"].copy_(x_cm[:, -1])
    return tm_out, rr * vv


def _wkv_chunked(r, k, v, logw, u, Q: int):
    """Chunked WKV from a zero state. r, k, v, logw: (B, S, H, P); u:
    (H, P). Returns (y (B, S, H, P), last state (B, H, P, P)), f32. Zero
    padding to a whole chunk is inert (decay 1, no state added)."""
    B, S, H, P = r.shape
    Q = min(Q, S)
    pad = (-S) % Q
    if pad:
        z = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))
        y, s = _wkv_chunked(z(r), z(k), z(v), z(logw), u, Q)
        return y[:, :S], s
    nc = S // Q
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)                       # s < t
    s = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    zero = torch.zeros((), device=r.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        rq, kq, vq, wq = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        lcum = torch.cumsum(wq, dim=1)        # inclusive cumulative log decay
        lq_prev = lcum - wq                   # up to t - 1
        rd = rq * torch.exp(lq_prev)
        kd = kq * torch.exp(-lcum)
        att = torch.einsum("bthp,bshp->bhts", rd, kd)
        att = torch.where(mask[None, None], att, zero)
        bonus = (rq * u * kq).sum(dim=-1)                          # (B,Q,H)
        y = torch.einsum("bhts,bshp->bthp", att, vq)
        y = y + bonus[..., None] * vq
        y = y + torch.einsum("bthp,bhpq->bthq", rd, s)
        ltot = lcum[:, -1]                                          # (B,H,P)
        kdec = kq * torch.exp(ltot[:, None] - lcum)
        s = torch.exp(ltot)[..., None] * s + torch.einsum(
            "bshp,bshq->bhpq", kdec, vq)
        ys.append(y)
    return torch.cat(ys, dim=1), s
