"""Building blocks: weight views, RMSNorm, rotary embedding, gated MLP,
embedding lookup. Every GEMM goes through ``core.quantizer.qeinsum``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lns import is_lns_weight, lns_decode_packed
from repro_torch.core.quantizer import QuantConfig, qeinsum
from repro_torch.models.common import ArchConfig

__all__ = ["dense_of", "decoded_of", "rms_norm", "rope", "apply_rope",
           "mlp_apply", "embed_lookup"]


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
    """Gated SiLU MLP: down(silu(gate(x)) * up(x))."""
    up = qeinsum("bsd,df->bsf", x, dense_of(p["up"], cfg), qcfg)
    gate = qeinsum("bsd,df->bsf", x, dense_of(p["gate"], cfg), qcfg)
    return qeinsum("bsf,fd->bsd", F.silu(gate) * up, dense_of(p["down"], cfg),
                   qcfg)


def embed_lookup(table, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Rows of the embedding table for ``tokens``. A packed table decodes
    only the gathered rows: decoding is elementwise, so this equals
    gathering from the decoded table."""
    if is_lns_weight(table):
        rows = lns_decode_packed(table.packed[tokens], table.fmt,
                                 torch.float32)
        x = (rows * table.scale).to(cfg.compute_dtype)
    else:
        x = table[tokens]
    return x.to(cfg.compute_dtype)
