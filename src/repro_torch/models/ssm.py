"""Mamba2 (SSD) block, as ``repro.models.ssm``: chunked scan for
training, one step a position with a state.

The selective-state recurrence h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_t^T,
y_t = C_t·h_t + D·x_t runs chunk-parallel without a state (masked-decay
attention within chunks of ``cfg.ssm_chunk`` positions plus a
cross-chunk state scan) and one step a position with one (every prefill
and decode step). Every projection is a quantized GEMM; the recurrence
stays f32 and plain torch, as the JAX package computes it outside any
Pallas kernel. One group (B/C shared across heads); the depthwise causal
conv of width ``ssm_conv_width`` is a sum of shifts. A state dict is
updated **in place**.

Under a serving mesh the mixer is replicated: its projections are
``ssm_inner`` or unnamed, which the serving rules keep whole, so every
rank computes the whole mixer with no collective and holds the whole
state, equal to one card's. JAX's cache table names ``act_heads`` for
``ssm``; that is a GSPMD placement, which changes no value, and the port
does not slice the state.

The JAX package's three-operand einsums are written as pairwise
contractions: contracted left to right, ``bkhp,bkn,bkh->bhpn`` would
build a (B, Q, H, P, N) product first (470 MB a chunk for zamba2-7b at
4 x 256), so the decay scales ``dt·x`` before the contraction.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantizer import QuantConfig, act_stat, qeinsum
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import decoded_of, dense_of, rms_norm

__all__ = ["mamba_leaves", "mamba_apply", "init_mamba_state", "softplus"]


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    return d_in, d_in // p, p, cfg.ssm_state_dim


def mamba_leaves(cfg: ArchConfig):
    """``(name, spec)`` of ``mamba_init``'s leaves in its order: specs as
    ``rwkv.rwkv_leaves``' and ``("normal", shape, std)`` (f32)."""
    d = cfg.d_model
    d_in, h, _, n = _dims(cfg)
    w = cfg.ssm_conv_width
    dt = cfg.compute_dtype
    return [("z_proj", ("dense", d, d_in, dt)),
            ("x_proj", ("dense", d, d_in, dt)),
            ("b_proj", ("dense", d, n, dt)), ("c_proj", ("dense", d, n, dt)),
            ("dt_proj", ("dense", d, h, dt)),
            ("conv_wx", ("normal", (w, d_in), w ** -0.5)),
            ("conv_wb", ("normal", (w, n), w ** -0.5)),
            ("conv_wc", ("normal", (w, n), w ** -0.5)),
            ("conv_b", ("const", (d_in + 2 * n,), 0.0)),
            ("A_log", ("const", (h,), 0.0)),       # A = -exp(A_log) = -1
            ("D", ("const", (h,), 1.0)),
            ("dt_bias", ("const", (h,), 0.0)),
            ("norm", ("const", (d_in,), 0.0)),
            ("out_proj", ("dense", d_in, d, dt))]


def init_mamba_state(batch: int, cfg: ArchConfig,
                     device) -> Dict[str, torch.Tensor]:
    d_in, h, p, n = _dims(cfg)
    w = cfg.ssm_conv_width - 1
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"conv_x": z(batch, w, d_in), "conv_b": z(batch, w, n),
            "conv_c": z(batch, w, n), "ssm": z(batch, h, p, n)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as JAX computes it, with
    no threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: Optional[torch.Tensor]):
    """Depthwise causal conv of ``xbc (B, S, C)`` as a sum of shifted
    slices in JAX's order, then the bias and silu. Returns (out, the last
    ``width - 1`` inputs: the next call's prefix)."""
    width = w.shape[0]
    pad = (torch.zeros_like(xbc[:, :width - 1]) if prefix is None
           else prefix.to(xbc.dtype))
    full = torch.cat([pad, xbc], dim=1)                 # (B, S+w-1, C)
    S = xbc.shape[1]
    out = full[:, 0:S] * w[0]
    for i in range(1, width):
        out = out + full[:, i:i + S] * w[i]
    return F.silu(out + b), full[:, S:]


def mamba_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig,
                qcfg: Optional[QuantConfig],
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The block's output (B, S, D); with ``state`` the scan runs one step
    a position from it and the state is updated in place."""
    B, S, D = x.shape
    d_in, H, P, N = _dims(cfg)
    f32 = torch.float32
    xs = act_stat(x, qcfg)        # one reduce for the five projections
    z, xin, bin_, cin, dt_raw = (
        qeinsum(eq, x, dense_of(p[name], cfg), qcfg, x_stat=xs)
        for eq, name in (("bsd,de->bse", "z_proj"), ("bsd,de->bse", "x_proj"),
                         ("bsd,dn->bsn", "b_proj"), ("bsd,dn->bsn", "c_proj"),
                         ("bsd,dh->bsh", "dt_proj")))
    bias_x, bias_b, bias_c = torch.split(p["conv_b"], [d_in, N, N])
    pre = state if state is not None else {}
    xs, new_cx = _causal_conv(xin.to(f32), decoded_of(p["conv_wx"], cfg),
                              bias_x, pre.get("conv_x"))
    Bv, new_cb = _causal_conv(bin_.to(f32), decoded_of(p["conv_wb"], cfg),
                              bias_b, pre.get("conv_b"))
    Cv, new_cc = _causal_conv(cin.to(f32), decoded_of(p["conv_wc"], cfg),
                              bias_c, pre.get("conv_c"))
    xs = xs.reshape(B, S, H, P)
    dt = softplus(dt_raw.to(f32) + p["dt_bias"])                  # (B,S,H)
    A = -torch.exp(p["A_log"])
    dA = dt * A                                                   # log decay

    if state is None:
        y, _ = _ssd_chunked(xs, dt, dA, Bv, Cv, cfg.ssm_chunk)
    else:
        h = state["ssm"]
        ys = []
        for t in range(S):
            xt, dtt, bt, ct = xs[:, t], dt[:, t], Bv[:, t], Cv[:, t]
            upd = (xt * dtt[..., None])[..., None] * bt[:, None, None, :]
            h = torch.exp(dA[:, t])[:, :, None, None] * h + upd
            ys.append(torch.einsum("bhpn,bn->bhp", h, ct))
        y = torch.stack(ys, dim=1)                                # (B,S,H,P)
        state["ssm"].copy_(h)
        state["conv_x"].copy_(new_cx)
        state["conv_b"].copy_(new_cb)
        state["conv_c"].copy_(new_cc)

    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return qeinsum("bse,ed->bsd", y, dense_of(p["out_proj"], cfg), qcfg)


def _ssd_chunked(xs, dt, dA, Bv, Cv, Q: int):
    """Chunk-parallel SSD from a zero state. xs: (B, S, H, P); dt, dA:
    (B, S, H); Bv, Cv: (B, S, N). Returns (y (B, S, H, P), last state
    (B, H, P, N)). Zero padding to a whole chunk is inert."""
    B, S, H, P = xs.shape
    N = Bv.shape[-1]
    Q = min(Q, S)
    pad = (-S) % Q
    if pad:
        z = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        y, h = _ssd_chunked(z(xs), z(dt), z(dA), z(Bv), z(Cv), Q)
        return y[:, :S], h
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xs.device)
    zero = torch.zeros((), device=xs.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, daq, bq, cq = xs[:, sl], dt[:, sl], dA[:, sl], Bv[:, sl], \
            Cv[:, sl]
        l = torch.cumsum(daq, dim=1)                        # (B,Q,H) inclusive
        dtx = xq * dtq[..., None]                           # (B,Q,H,P)
        # intra-chunk: masked decay attention
        g = torch.einsum("bqn,bkn->bqk", cq, bq)            # (B,Q,Q)
        ldiff = l[:, :, None, :] - l[:, None, :, :]         # (B,Q,K,H)
        m = torch.where(mask[None, :, :, None], torch.exp(ldiff), zero)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", g[..., None] * m, dtx)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bqn,bhpn->bqhp", cq, h) * \
            torch.exp(l)[..., None]
        # chunk-end state
        ltot = l[:, -1]                                     # (B,H)
        decay_rest = torch.exp(ltot[:, None] - l)           # (B,Q,H)
        s_chunk = torch.einsum("bkhp,bkn->bhpn", dtx * decay_rest[..., None],
                               bq)
        h = torch.exp(ltot)[:, :, None, None] * h + s_chunk
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h
