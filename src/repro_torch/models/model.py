"""The dense decoder: parameter init, cached forward, decode step.

Parameters are a nested dict laid out leaf for leaf as the JAX package's
pytree: the layer ("period") parameters carry a leading stack axis of
``num_layers`` (``period/pos0/...``), which this module walks with a
Python loop where the JAX package scans. Weights may be packed
:class:`LNSWeight` leaves; the 2-D slices of a stacked packed leaf route
through the kernels.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.quantizer import QuantConfig, qeinsum
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (decoded_of, embed_lookup, mlp_apply,
                                       rms_norm)

__all__ = ["init_params", "forward", "lm_head", "init_caches", "decode_step",
           "layer", "to_device"]


def _trunc_normal(shape, std, dtype, gen: torch.Generator, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random dense parameters from a ``torch.Generator`` seeded with
    ``seed``: truncated normals (std 1/sqrt(fan_in), embeddings 0.02),
    zero norm gains, as the JAX package draws them. The two frameworks'
    streams differ; carry JAX parameters across with ``repro_torch.convert``
    where the same weights are needed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.compute_dtype
    d, L = cfg.d_model, cfg.num_layers
    h, kv, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff

    def dense(d_in, d_out):
        return _trunc_normal((L, d_in, d_out), 1.0 / math.sqrt(d_in), dt, gen,
                             dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    mlp = {"up": dense(d, f), "gate": dense(d, f), "down": dense(f, d)}
    params: Dict[str, Any] = {
        "embed": {"tok": _trunc_normal((cfg.vocab_size, d), 0.02, dt, gen,
                                       dev)},
        "final_norm": zeros(d),
        "period": {"pos0": {
            "ln1": zeros(L, d),
            "attn": {"wq": dense(d, h * hd), "wk": dense(d, kv * hd),
                     "wv": dense(d, kv * hd), "wo": dense(h * hd, d)},
            "ln2": zeros(L, d),
            "mlp": mlp,
        }},
    }
    return params


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views; packed leaves stay packed)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def lm_head(params, cfg: ArchConfig) -> torch.Tensor:
    """The tied LM head ``(d, V)``: the decoded embedding, transposed. A
    pure function of the weights, so the engine decodes it once; the
    fake-quant leg of ``qeinsum`` puts it on the weight grid per call, as
    the JAX package does."""
    return decoded_of(params["embed"]["tok"], cfg).T


def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            qcfg: Optional[QuantConfig] = None, *, caches: Dict[str, Any],
            pos_offset=0, block_tables: Optional[torch.Tensor] = None,
            head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the decoder over ``tokens (B, S)`` in append mode, writing the
    new positions into ``caches`` in place. ``pos_offset`` is a scalar or
    a (B,) tensor of per-row offsets. Returns logits ``(B, S, V)``."""
    x = embed_lookup(params["embed"]["tok"], tokens, cfg)
    S = x.shape[1]
    off = torch.as_tensor(pos_offset, device=x.device)
    positions = (off[..., None] + torch.arange(S, device=x.device)).to(
        torch.int32)
    if positions.dim() > 1 and positions.shape[0] == 1:
        positions = positions[0]
    stack, cstack = params["period"]["pos0"], caches["period"]["pos0"]
    for i in range(cfg.num_layers):
        bp, c = layer(stack, i), layer(cstack, i)
        hdn = rms_norm(x, bp["ln1"], cfg.norm_eps)
        x = x + attn_mod.attn_apply(bp["attn"], hdn, cfg, qcfg,
                                    positions=positions, cache=c,
                                    block_table=block_tables)
        hdn = rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], hdn, cfg, qcfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if head is None:
        head = lm_head(params, cfg)
    return qeinsum("bsd,dv->bsv", x, head, qcfg)


def init_caches(batch: int, max_len: int, cfg: ArchConfig, *,
                page_size: Optional[int] = None,
                num_pages: Optional[int] = None, device=None):
    """Decode caches, stacked over layers: a dense ``(batch, max_len)``
    buffer per layer, or with ``page_size`` a paged pool per layer
    (default ``batch * ceil(max_len / page_size)`` pages)."""
    dev = resolve_device(device)
    if page_size is not None:
        if num_pages is None:
            num_pages = batch * (-(-max_len // page_size))
        one = attn_mod.init_paged_kv_cache(batch, num_pages, page_size, cfg,
                                           dev)
    else:
        one = attn_mod.init_kv_cache(batch, max_len, cfg, dev)
    L = cfg.num_layers
    stacked = {k: v.unsqueeze(0).repeat((L,) + (1,) * v.dim())
               for k, v in one.items()}
    return {"period": {"pos0": stacked}}


def decode_step(params, caches, tokens: torch.Tensor, cfg: ArchConfig,
                qcfg: Optional[QuantConfig] = None, *, pos_offset,
                block_tables: Optional[torch.Tensor] = None,
                head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One incremental step: last-position logits ``(B, V)``."""
    return forward(params, tokens, cfg, qcfg, caches=caches,
                   pos_offset=pos_offset, block_tables=block_tables,
                   head=head)[:, -1]


def to_device(tree, device):
    """Move a parameter tree (tensors and packed weights) to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
