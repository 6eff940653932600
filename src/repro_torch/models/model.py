"""The dense decoder: parameter init, forward (training or cached),
loss, decode step.

Parameters are a nested dict laid out leaf for leaf as the JAX package's
pytree: the layer ("period") parameters carry a leading stack axis of
``num_layers`` (``period/pos0/...``), which this module walks with a
Python loop where the JAX package scans. Weights may be packed
:class:`LNSWeight` leaves; the 2-D slices of a stacked packed leaf route
through the kernels. There is no rematerialization: at smollm-135m's
width a 2048-token training step keeps its activations in a few GB.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.quantizer import QuantConfig, qeinsum
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (decoded_of, dense_of, embed_lookup,
                                       mlp_apply, rms_norm)

__all__ = ["init_params", "forward", "lm_loss", "lm_head", "init_caches",
           "decode_step", "layer", "to_device"]


def _trunc_normal(shape, std, dtype, gen: torch.Generator, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random dense parameters from a ``torch.Generator`` seeded with
    ``seed``: truncated normals (std 1/sqrt(fan_in), embeddings and an
    untied head ``embed.head (d, V)`` 0.02), zero norm gains, as the JAX
    package draws them; no ``gate`` when the MLP is ungated. The two
    frameworks' streams differ; carry JAX parameters across with
    ``repro_torch.convert`` where the same weights are needed."""
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

    mlp = {"up": dense(d, f)}
    if cfg.mlp_gated:
        mlp["gate"] = dense(d, f)
    mlp["down"] = dense(f, d)
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
    if not cfg.tie_embeddings:     # drawn last: tied configs keep their draws
        params["embed"]["head"] = _trunc_normal((d, cfg.vocab_size), 0.02,
                                                dt, gen, dev)
    return params


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views; packed leaves stay packed)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def lm_head(params, cfg: ArchConfig):
    """The LM head ``(d, V)``. Tied: the decoded embedding (``delta``
    included, so the table's gradient gathers from the lookup and the
    head), transposed; a pure function of the weights, so the engine
    decodes it once, and the fake-quant leg of ``qeinsum`` puts it on the
    weight grid per call, as the JAX package does. Untied:
    ``embed.head`` itself, still packed when it is, so ``qeinsum`` routes
    it through K1 and K2."""
    if not cfg.tie_embeddings:
        return dense_of(params["embed"]["head"], cfg)
    return decoded_of(params["embed"]["tok"], cfg).T


def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            qcfg: Optional[QuantConfig] = None, *,
            caches: Optional[Dict[str, Any]] = None,
            pos_offset=0, block_tables: Optional[torch.Tensor] = None,
            head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the decoder over ``tokens (B, S)``. Without ``caches``
    (training) the sequence attends causally to itself; with them (append
    mode) the new positions are written into ``caches`` in place.
    ``pos_offset`` is a scalar or a (B,) tensor of per-row offsets.
    Returns logits ``(B, S, V)``."""
    x = embed_lookup(params["embed"]["tok"], tokens, cfg)
    S = x.shape[1]
    off = torch.as_tensor(pos_offset, device=x.device)
    positions = (off[..., None] + torch.arange(S, device=x.device)).to(
        torch.int32)
    if positions.dim() > 1 and positions.shape[0] == 1:
        positions = positions[0]
    stack = params["period"]["pos0"]
    cstack = caches["period"]["pos0"] if caches is not None else None
    for i in range(cfg.num_layers):
        bp = layer(stack, i)
        c = layer(cstack, i) if cstack is not None else None
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


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32 over labels >= 0."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((logz - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            qcfg: Optional[QuantConfig] = None) -> torch.Tensor:
    """Next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (the dense family has no auxiliary loss)."""
    logits = forward(params, batch["tokens"], cfg, qcfg)
    return _xent(logits, batch["labels"])


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
