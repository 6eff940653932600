"""Building blocks: weight views, RMSNorm, rotary embedding, the MLP
(gated or not), embedding lookup. Every GEMM goes through
``core.quantizer.qeinsum``.

The JAX package wraps the f32 islands (norms, rope) in ``cot_boundary``
to keep their gradients in the network dtype; autograd already returns
each gradient in its input's dtype, so the port needs no boundary there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lns import is_lns_weight, lns_decode_packed
from repro_torch.core.quantizer import QuantConfig, act_stat, qeinsum
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import axis_group, axis_index
from repro_torch.models.common import ArchConfig

__all__ = ["dense_of", "decoded_of", "rms_norm", "rope", "apply_rope",
           "mlp_apply", "embed_lookup", "vocab_group", "ACT_FNS"]

ACT_FNS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def dense_of(w, cfg: ArchConfig):
    """A weight for a GEMM: 2-D packed weights stay packed (``qeinsum``
    routes them); higher-rank packed leaves decode here."""
    if is_lns_weight(w) and w.ndim != 2:
        return w.decode(cfg.compute_dtype)
    return w


def decoded_of(w, cfg: ArchConfig):
    """A dense view, for uses that are not GEMMs."""
    if is_lns_weight(w):
        return w.decode(cfg.compute_dtype)
    return w


def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics, applied in the compute dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps) * (1.0 + gain.to(torch.float32))
    return x * scale.to(x.dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """Rotary table for integer positions: (..., head_dim/2, 2) f32."""
    half = head_dim // 2
    lt = torch.log2(torch.tensor(theta, dtype=torch.float32,
                                 device=positions.device))
    freqs = torch.exp2(
        -lt * torch.arange(half, dtype=torch.float32,
                           device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate pairs of halves. x: (..., S, H, D); rot: (..., S, D/2, 2)."""
    xf = x.to(torch.float32)
    x1, x2 = xf.chunk(2, dim=-1)
    cos = rot[..., 0].unsqueeze(-2)
    sin = rot[..., 1].unsqueeze(-2)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig,
              qcfg: Optional[QuantConfig]) -> torch.Tensor:
    """down(act(gate(x)) * up(x)), or down(act(up(x))) when
    ``cfg.mlp_gated`` is off; ``act`` is ``ACT_FNS[cfg.act_fn]``. Under a
    mesh whose serving rules shard ``mlp``, ``up``/``gate`` are this
    rank's column blocks (K2 on the rank's columns of the replicated,
    K1-encoded activation) and the hidden state is all-gathered before
    the replicated ``down``, whose Q_A then sees the whole tensor. In
    training the gather's gradient is the rank's block, and ``x``'s is
    SUM-reduced over the group (``collectives.sum_grad``): each rank's
    columns give their part of it.

    Where the rules also split ``act_ff`` (``sharding.train_rules``),
    ``down`` holds this rank's rows: the rank's hidden columns are not
    gathered but encoded (K1) with the whole hidden state's Q_A scale
    (MAX-reduced over the batch and model groups) and multiplied (K2)
    against those rows, and the partial products are SUM-reduced over the
    group in f32 and rounded once to the compute dtype, as one device
    rounds its whole contraction (``collectives.sum_forward``; its
    backward passes the replicated gradient to every partial). The sum's
    order is the collective's, so the output may differ from one
    device's in its last bit."""
    act = ACT_FNS[cfg.act_fn]
    grp = axis_group("mlp")
    x = collectives.sum_grad(x, grp)
    xs = act_stat(x, qcfg)        # one reduce for up and gate
    up = qeinsum("bsd,df->bsf", x, dense_of(p["up"], cfg), qcfg, x_stat=xs,
                 out_axis="mlp")
    if cfg.mlp_gated:
        gate = qeinsum("bsd,df->bsf", x, dense_of(p["gate"], cfg), qcfg,
                       x_stat=xs, out_axis="mlp")
        up = act(gate) * up
    else:
        up = act(up)
    rows = axis_group("act_ff")
    if rows is not None:
        y = qeinsum("bsf,fd->bsd", up, dense_of(p["down"], cfg), qcfg,
                    x_stat=act_stat(up, qcfg, "act_ff"),
                    out_dtype=torch.float32)
        return collectives.sum_forward(y, rows).to(up.dtype)
    up = collectives.gather_with_grad(up, grp)
    return qeinsum("bsf,fd->bsd", up, dense_of(p["down"], cfg), qcfg)


def embed_lookup(table, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Rows of the embedding table for ``tokens``, times sqrt(d_model)
    with ``cfg.embed_scale``. A packed table decodes only the gathered
    rows: decoding is elementwise, so this equals gathering from the
    decoded table (``delta`` included). The scale is rounded to the
    compute dtype before the product, as the JAX package's weakly typed
    constant is.

    With ``cfg.num_codebooks`` = K, ``tokens`` is ``(B, S, K)`` and the
    table holds K blocks of ``vocab_size`` rows: codebook k's row sits at
    ``k * vocab_size + token``, and the K rows of a position are summed
    in f32, codebook 0 first, then rounded once to the compute dtype, as
    the JAX package's ``jnp.sum`` of the gathered rows is on the CPU."""
    if cfg.num_codebooks:
        offsets = torch.arange(cfg.num_codebooks, device=tokens.device) \
            * cfg.vocab_size
        rows = _gather(table, tokens + offsets, cfg).to(torch.float32)
        x = rows[..., 0, :]
        for k in range(1, cfg.num_codebooks):
            x = x + rows[..., k, :]
    else:
        x = _gather(table, tokens, cfg)
    x = x.to(cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def vocab_group(width: int, cfg: ArchConfig):
    """The model group the active rules split the vocabulary over (None
    where they keep it whole). ``width`` (an embedding table's rows, a
    head's or the logits' columns) must then be the rank's block of it."""
    grp = axis_group("vocab")
    if grp is not None:
        whole = cfg.vocab_size * max(1, cfg.num_codebooks)
        block = whole // collectives.group_size(grp)
        if width != block:
            raise ValueError(f"the rules split the vocabulary of {whole} "
                             f"over the model group, but a table, head or "
                             f"logits is {width} wide, not the rank's "
                             f"{block}")
    return grp


def _gather(table, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``table[tokens]`` in the compute dtype, decoding a packed table's
    gathered rows only.

    Where the rules split ``vocab`` and ``table`` holds this rank's block
    of rows (``sharding.train_rules``), a token outside the block gives a
    row of -0.0 and the rows are SUM-reduced over the model group
    (``collectives.sum_forward``): exactly one rank holds each token's
    row, and ``v + (-0.0)`` is ``v`` in any order, so the lookup equals
    the whole table's bit for bit. The table's gradient is the scatter of
    the rank's own tokens' rows."""
    rows = (table.packed if is_lns_weight(table) else table).shape[0]
    grp = vocab_group(rows, cfg)
    if grp is None:
        return _rows(table, tokens, cfg)
    local = tokens - axis_index("vocab") * rows
    inside = (local >= 0) & (local < rows)
    x = _rows(table, local.clamp(0, rows - 1), cfg)
    x = x.masked_fill(~inside[..., None], -0.0)
    return collectives.sum_forward(x, grp)


def _rows(table, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if is_lns_weight(table):
        rows = lns_decode_packed(table.packed[tokens], table.fmt,
                                 torch.float32)
        x = (rows * table.scale).to(cfg.compute_dtype)
        if table.delta is not None:
            x = x + table.delta[tokens].to(cfg.compute_dtype)
    else:
        x = table[tokens]
    return x.to(cfg.compute_dtype)
