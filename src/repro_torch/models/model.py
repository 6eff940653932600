"""The dense decoder: parameter init, forward (training or cached),
loss, decode step.

Parameters are a nested dict laid out leaf for leaf as the JAX package's
pytree: ``ArchConfig.layer_pattern()`` gives ``prefix`` unrolled layers
(a list, ``prefix/<i>/...``) and ``n_periods`` repetitions of a period of
layer kinds, each position's parameters stacked on a leading axis
(``period/pos<j>/...``), which this module walks with a Python loop where
the JAX package scans. Weights may be packed :class:`LNSWeight` leaves;
the 2-D slices of a stacked packed leaf route through the kernels.

Layer kinds: ``dense`` (full-context attention), and gemma3's ``local``
(sliding window, ring cache) and ``global`` (full context, its own rope
theta). The modality stubs' trunks are the dense one: phi-3-vision's
patch prefix and musicgen's codebooks change only the embedding, the
head and the loss. The recurrent kinds: ``rwkv`` (RWKV6 time-mix and
channel-mix, both reading the block's input: JAX's parallel-block
residual), ``mamba`` (Mamba2 SSD) and ``shared_attn`` (zamba2's one
attention block and MLP at ``params["shared"]``, re-applied with each
occurrence's own norms and a LoRA delta on the fused QKV weights).
The mixture of experts: ``moe`` (attention, then routed and shared
experts, ``models.moe``; each such layer adds its balance loss to the
forward's ``aux``), with MLA (``models.attention.mla_apply``) in every
attention layer when ``cfg.use_mla`` is set, and deepseek-v3's
multi-token-prediction module at ``params["mtp"]`` in the loss.
``forward(remat=True)`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``) instead of keeping its activations.

Under a data-parallel mesh each rank holds its rows of the global batch
and :func:`lm_loss` returns the rank's share of the global loss: its
masked sums over the global label count (SUM-reduced without a
gradient), so the ranks' losses and gradients sum to the one-device
ones. The recompute runs in the backward, perhaps on autograd's device
thread, so it re-enters the forward's mesh context and reissues the
forward's MAX reduces in the same order on every rank.

Under JAX's training placement (``sharding.train_rules``) the vocabulary
is split over the model group: the rank's block of the embedding's rows
(``layers.embed_lookup``), of the head's columns and of the logits, and
:func:`lm_loss`'s cross entropy is taken over the logits' blocks
(:func:`_xent`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.lns import LNSWeight, is_lns_weight
from repro_torch.core.quantizer import QuantConfig, qeinsum
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.params_sharding import cache_local_shape
from repro_torch.distributed.sharding import (axis_index, axis_shards,
                                              batch_group, current_mesh,
                                              current_rules, shard_ctx)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (decoded_of, dense_of, embed_lookup,
                                       mlp_apply, rms_norm, vocab_group)

__all__ = ["ForwardOut", "init_params", "forward", "lm_loss", "lm_head",
           "init_caches", "decode_step", "layer", "layers", "to_device"]


class ForwardOut(NamedTuple):
    """``forward(full=True)``: the logits, the summed MoE balance loss
    (0 without ``moe`` layers) and the final hidden state (after the
    final norm), as the JAX package's ``ForwardOut`` without the caches,
    which the port updates in place."""
    logits: torch.Tensor
    aux: torch.Tensor
    hidden: torch.Tensor

# a draw whose f32 temporary would pass this many bytes is made in slices
# of its leading axis (whole layers of a stack, rows of a table), one
# after another from the same generator. The values differ from a whole
# draw's (trunc_normal_ resamples what falls outside [-2, 2] over the
# whole tensor), so only leaves past it draw differently: none of
# smollm-135m or BERT-base/large comes near it, and their draws are
# unchanged
_DRAW_SLICE_BYTES = 1 << 30


def _draw(shape, std, dtype, gen: torch.Generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * t).to(dtype)


def _trunc_normal(shape, std, dtype, gen: torch.Generator, device):
    """``std`` times a normal truncated to [-2, 2], in ``dtype``."""
    row = 4 * math.prod(shape[1:])
    if len(shape) < 2 or row * shape[0] <= _DRAW_SLICE_BYTES:
        return _draw(shape, std, dtype, gen, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    n = max(1, _DRAW_SLICE_BYTES // row)
    for i in range(0, shape[0], n):
        out[i:i + n] = _draw(out[i:i + n].shape, std, dtype, gen, device)
    return out


def _expert_stack(path, n, E: int, d_in: int, d_out: int, std: float,
                  dtype, gen: torch.Generator, device, fn, keep=None):
    """An expert stack ``(n, E, d_in, d_out)`` (``(E, d_in, d_out)`` with
    ``n`` None) of normals times ``std``, drawn a layer and a chunk of
    experts at a time (each chunk's f32 draw at most
    ``_DRAW_SLICE_BYTES``) and passed to ``fn`` chunk by chunk. ``fn``'s
    packed chunks (per-expert, per-output-channel scales: the chunks do
    not share one) are written into one packed leaf. ``keep = (lo, hi)``
    keeps experts ``[lo, hi)`` only (a rank's share under expert
    parallelism): every chunk is still drawn, so the kept experts are the
    whole draw's, but only theirs reach ``fn``."""
    lo, hi = keep or (0, E)
    per = max(1, _DRAW_SLICE_BYTES // (4 * d_in * d_out))
    lead = (n,) if n else ()
    out = None
    for li in range(n or 1):
        for e0 in range(0, E, per):
            e1 = min(E, e0 + per)
            t = torch.randn((e1 - e0, d_in, d_out), generator=gen,
                            dtype=torch.float32, device=device)
            a, b = max(e0, lo), min(e1, hi)
            if a >= b:
                continue
            w = fn(path, (t[a - e0:b - e0] * std).to(dtype))
            at = ((li,) if n else ()) + (slice(a - lo, b - lo),)
            if out is None:
                if is_lns_weight(w):
                    out = LNSWeight(
                        torch.empty(lead + (hi - lo, d_in, d_out),
                                    dtype=w.packed.dtype, device=device),
                        torch.empty(lead + (hi - lo,)
                                    + tuple(w.scale.shape[1:]),
                                    dtype=w.scale.dtype, device=device),
                        w.fmt)
                else:
                    out = torch.empty(lead + (hi - lo, d_in, d_out),
                                      dtype=w.dtype, device=device)
            if is_lns_weight(out):
                out.packed[at] = w.packed
                out.scale[at] = w.scale
            else:
                out[at] = w
    return out


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None,
                leaf_fn: Optional[Callable] = None,
                shard=None) -> Dict[str, Any]:
    """Random dense parameters from a ``torch.Generator`` seeded with
    ``seed``: truncated normals (std 1/sqrt(fan_in), embeddings and an
    untied head ``embed.head (d, V)`` 0.02; with K codebooks the table
    has ``K * V`` rows and the head ``K * V`` columns), zero norm gains
    and biases, as the JAX package draws them; no ``gate`` when the MLP
    is ungated. The draw order: every layer stack's MLP, the embedding,
    every stack's attention, the head. The two frameworks' streams differ;
    carry JAX parameters across with ``repro_torch.convert`` where the
    same weights are needed.

    ``leaf_fn(path, tensor)``, when given, replaces each leaf as soon as
    it is made (``optim.madam.lns_leaf_encoder`` encodes it), so at most
    one dense leaf exists at a time.

    The recurrent kinds draw after every attention stack: each ``rwkv`` or
    ``mamba`` stack's leaves in ``rwkv_leaves``/``mamba_leaves`` order
    (their conv weights normals), each ``shared_attn`` occurrence's
    ``lora_a`` (``lora_b`` starts at zero), then the shared block's
    attention and MLP. A dense config draws none of these, so its draws
    are unchanged.

    With ``cfg.use_mla`` every attention leaf set is MLA's
    (``attention.mla_leaves``) in the attention stacks' place. The ``moe``
    stacks draw after the recurrent ones: each stack's attention, then
    its ``moe_leaves`` (the expert stacks normals, drawn and passed to
    ``leaf_fn`` a layer and a chunk of experts at a time, so no whole
    dense stack exists), then the MTP module (a ``dense`` block, its
    norm, the ``2d -> d`` projection), then the head.

    ``shard`` (a ``distributed.params_sharding.LocalShard``) keeps this
    rank's shard of every leaf as soon as ``leaf_fn`` has made it, and
    only the rank's experts of an expert stack: the draws are the whole
    tree's, so each rank holds its slice of the same weights."""
    dev = resolve_device(device)
    # meta draws nothing; its ops take (and ignore) a CPU generator
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    dt = cfg.compute_dtype
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    enc = leaf_fn or (lambda path, w: w)
    fn = enc if shard is None else (lambda path, w: shard(path,
                                                          enc(path, w)))
    prefix, n_periods, period = cfg.layer_pattern()
    # (path, stack size or None, kind): the period positions, then the
    # prefix; the attention stacks hold the dense kinds
    every = [(("period", f"pos{j}"), n_periods, kind)
             for j, kind in enumerate(period) if n_periods]
    every += [(("prefix", i), None, kind) for i, kind in enumerate(prefix)]
    stacks = [(path, n) for path, n, kind in every
              if kind in ("dense", "local", "global")]

    def dense(path, n, d_in, d_out):
        lead = (n,) if n else ()
        return fn(path, _trunc_normal(lead + (d_in, d_out),
                                      1.0 / math.sqrt(d_in), dt, gen, dev))

    def zeros(path, *shape, dtype=torch.float32):
        return fn(path, torch.zeros(shape, dtype=dtype, device=dev))

    def leaf(path, n, spec):
        """One leaf of ``rwkv_leaves``/``mamba_leaves``' specs."""
        lead = (n,) if n else ()
        if spec[0] == "dense":
            _, d_in, d_out, dtype = spec
            return fn(path, _trunc_normal(lead + (d_in, d_out),
                                          1.0 / math.sqrt(d_in), dtype, gen,
                                          dev))
        if spec[0] == "normal":
            t = torch.randn(lead + spec[1], generator=gen, device=dev,
                            dtype=torch.float32)
            return fn(path, t * spec[2])
        return fn(path, torch.full(lead + spec[1], spec[2],
                                   dtype=torch.float32, device=dev))

    def mlp_leaves(path, n):
        mlp = {"up": dense(path + ("mlp", "up"), n, d, f)}
        if cfg.mlp_gated:
            mlp["gate"] = dense(path + ("mlp", "gate"), n, d, f)
        mlp["down"] = dense(path + ("mlp", "down"), n, f, d)
        return mlp

    def attn_leaves(path, n):
        lead = (n,) if n else ()
        if cfg.use_mla:
            return {name: (dense(path + ("attn", name), n, spec[1], spec[2])
                           if spec[0] == "dense" else
                           zeros(path + ("attn", name), *lead, spec[1]))
                    for name, spec in attn_mod.mla_leaves(cfg)}
        a = {"wq": dense(path + ("attn", "wq"), n, d, h * hd),
             "wk": dense(path + ("attn", "wk"), n, d, kv * hd),
             "wv": dense(path + ("attn", "wv"), n, d, kv * hd),
             "wo": dense(path + ("attn", "wo"), n, h * hd, d)}
        for k, (shape, dtype) in attn_mod.attn_zero_leaves(cfg).items():
            a[k] = zeros(path + ("attn", k), *lead, *shape, dtype=dtype)
        return a

    def moe_leaves(path, n):
        out: Dict[str, Any] = {}
        for name, spec in moe_mod.moe_leaves(cfg):
            lp = path + ("moe",) + tuple(name.split("/"))
            if spec[0] == "experts":
                keep = (None if shard is None else shard.experts(
                    lp, 4 if n else 3, cfg.num_experts))
                w = _expert_stack(lp, n, cfg.num_experts, *spec[1:], dt,
                                  gen, dev, enc, keep)
            else:
                _, d_in, d_out, dtype = spec
                lead = (n,) if n else ()
                w = fn(lp, _trunc_normal(lead + (d_in, d_out),
                                         1.0 / math.sqrt(d_in), dtype, gen,
                                         dev))
            node = out
            for part in name.split("/")[:-1]:
                node = node.setdefault(part, {})
            node[name.split("/")[-1]] = w
        return out

    mlps = {path: mlp_leaves(path, n) for path, n in stacks}
    rows = cfg.vocab_size * (cfg.num_codebooks or 1)   # K blocks of V rows
    embed = {"tok": fn(("embed", "tok"), _trunc_normal(
        (rows, d), 0.02, dt, gen, dev))}
    params: Dict[str, Any] = {"embed": embed,
                              "final_norm": zeros(("final_norm",), d)}
    blocks = {}
    for path, n in stacks:
        lead = (n,) if n else ()
        a = attn_leaves(path, n)
        blocks[path] = {"ln1": zeros(path + ("ln1",), *lead, d), "attn": a,
                        "ln2": zeros(path + ("ln2",), *lead, d),
                        "mlp": mlps[path]}
    specs = {"rwkv": rwkv_mod.rwkv_leaves, "mamba": ssm_mod.mamba_leaves}
    for path, n, kind in every:
        lead = (n,) if n else ()
        if kind in specs:
            inner = "rwkv" if kind == "rwkv" else "mamba"
            lns = ("ln1", "ln2") if kind == "rwkv" else ("ln",)
            blocks[path] = {ln: zeros(path + (ln,), *lead, d) for ln in lns}
            blocks[path][inner] = {
                name: leaf(path + (inner, name), n, spec)
                for name, spec in specs[kind](cfg)}
        elif kind == "shared_attn":
            blocks[path] = {"ln1": zeros(path + ("ln1",), *lead, d),
                            "ln2": zeros(path + ("ln2",), *lead, d)}
            r = cfg.shared_block_lora_rank
            if r:
                blocks[path]["lora_a"] = dense(path + ("lora_a",), n, d, r)
                blocks[path]["lora_b"] = zeros(
                    path + ("lora_b",), *lead, r, (h + 2 * kv) * hd,
                    dtype=dt)
    if "shared_attn" in period or "shared_attn" in prefix:
        params["shared"] = {"attn": attn_leaves(("shared",), None),
                            "mlp": mlp_leaves(("shared",), None)}
    for path, n, kind in every:
        if kind == "moe":
            lead = (n,) if n else ()
            blocks[path] = {"ln1": zeros(path + ("ln1",), *lead, d),
                            "attn": attn_leaves(path, n),
                            "ln2": zeros(path + ("ln2",), *lead, d),
                            "moe": moe_leaves(path, n)}
    if cfg.mtp_depth:
        mtp = ("mtp",)
        block = {"ln1": zeros(mtp + ("block", "ln1"), d),
                 "attn": attn_leaves(mtp + ("block",), None),
                 "ln2": zeros(mtp + ("block", "ln2"), d),
                 "mlp": mlp_leaves(mtp + ("block",), None)}
        params["mtp"] = {"block": block, "norm": zeros(mtp + ("norm",), d),
                         "proj": dense(mtp + ("proj",), None, 2 * d, d)}
    if not cfg.tie_embeddings:     # drawn last: tied configs keep their draws
        embed["head"] = fn(("embed", "head"), _trunc_normal(
            (d, rows), 0.02, dt, gen, dev))
    if prefix:
        params["prefix"] = [blocks[("prefix", i)] for i in range(len(prefix))]
    if n_periods:
        params["period"] = {f"pos{j}": blocks[("period", f"pos{j}")]
                            for j in range(len(period))}
    return params


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views; packed leaves stay packed)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def layers(cfg: ArchConfig, params, caches=None) -> Iterator:
    """``(kind, block params, block cache or None)`` in layer order: the
    prefix, then every period's positions."""
    prefix, n_periods, period = cfg.layer_pattern()
    for i, kind in enumerate(prefix):
        c = caches["prefix"][i] if caches is not None else None
        yield kind, params["prefix"][i], c
    for li in range(n_periods):
        for j, kind in enumerate(period):
            key = f"pos{j}"
            c = (layer(caches["period"][key], li) if caches is not None
                 else None)
            yield kind, layer(params["period"][key], li), c


def _attn_kind_args(cfg: ArchConfig, kind: str):
    """(window, rope theta) of a layer kind."""
    window = cfg.sliding_window if kind == "local" else None
    theta = ((cfg.rope_theta_global or cfg.rope_theta) if kind == "global"
             else cfg.rope_theta)
    return window, theta


def _block(kind: str, bp, x: torch.Tensor, cfg: ArchConfig, qcfg,
           positions, cache, block_tables, shared=None):
    """One layer: ``(x, aux)``, ``aux`` the balance loss of a ``moe``
    layer and None for every other kind."""
    if kind == "mamba":
        hdn = rms_norm(x, bp["ln"], cfg.norm_eps)
        return x + ssm_mod.mamba_apply(bp["mamba"], hdn, cfg, qcfg,
                                       state=cache), None
    if kind == "rwkv":
        # the parallel-block residual: both halves read the block's input
        tm, cm = rwkv_mod.rwkv_apply(
            bp["rwkv"], rms_norm(x, bp["ln1"], cfg.norm_eps),
            rms_norm(x, bp["ln2"], cfg.norm_eps), cfg, qcfg, state=cache)
        return x + tm + cm, None
    if kind == "shared_attn":
        hdn = rms_norm(x, bp["ln1"], cfg.norm_eps)
        attn_p = shared["attn"]
        if "lora_a" in bp:
            attn_p = _lora_qkv(attn_p, bp, cfg)
        x = x + attn_mod.attn_apply(attn_p, hdn, cfg, qcfg,
                                    positions=positions, cache=cache,
                                    block_table=block_tables)
        hdn = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + mlp_apply(shared["mlp"], hdn, cfg, qcfg), None
    window, theta = _attn_kind_args(cfg, kind)
    hdn = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        x = x + attn_mod.mla_apply(bp["attn"], hdn, cfg, qcfg,
                                   positions=positions, cache=cache)
    else:
        x = x + attn_mod.attn_apply(bp["attn"], hdn, cfg, qcfg,
                                    positions=positions, window=window,
                                    theta=theta, cache=cache,
                                    block_table=block_tables)
    hdn = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if kind == "moe":
        m, aux = moe_mod.moe_apply(bp["moe"], hdn, cfg, qcfg)
        return x + m, aux
    return x + mlp_apply(bp["mlp"], hdn, cfg, qcfg), None


def _lora_qkv(attn_p, bp, cfg: ArchConfig):
    """zamba2: the shared QKV weights decoded plus this occurrence's LoRA
    delta ``lora_a @ lora_b`` (compute dtype). Dense weights take
    ``qeinsum``'s fake-quant leg, not K2, as in the JAX package; ``wo``
    stays packed. The delta is always the whole ``[q | k | v]`` product;
    a ``wq``/``wk``/``wv`` held as this rank's column block (a mesh that
    shards ``qkv_out``) takes the delta's columns of the rank's heads in
    each of the three blocks, so the merged block is one card's merged
    weight restricted to those heads, bit for bit. The serving placement
    keeps them whole (``params_sharding.kept_whole``)."""
    delta = decoded_of(bp["lora_a"], cfg) @ decoded_of(bp["lora_b"], cfg)
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    out = dict(attn_p)
    for name, lo, width in (("wq", 0, q_dim), ("wk", q_dim, kv_dim),
                            ("wv", q_dim + kv_dim, kv_dim)):
        w = decoded_of(attn_p[name], cfg)
        n = w.shape[-1]
        if n != width and width != n * axis_shards("qkv_out"):
            raise ValueError(f"{name}: {n} columns are neither the whole "
                             f"{width} nor a qkv_out block of them")
        at = lo + (axis_index("qkv_out") * n if n != width else 0)
        out[name] = w + delta[:, at:at + n]
    return out


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
            patches: Optional[torch.Tensor] = None,
            caches: Optional[Dict[str, Any]] = None,
            pos_offset=0, block_tables: Optional[torch.Tensor] = None,
            head: Optional[torch.Tensor] = None,
            remat: bool = False, full: bool = False):
    """Run the decoder over ``tokens (B, S)``, or ``(B, S, K)`` with K
    codebooks. ``patches (B, P, d_model)`` (phi-3-vision's precomputed
    patch embeddings) go in front of the token embeddings, cast to the
    compute dtype and not scaled, and the positions run over both.
    Without ``caches`` (training) the sequence attends causally to
    itself; with them (append mode) the new positions are written into
    ``caches`` in place.
    ``pos_offset`` is a scalar or a (B,) tensor of per-row offsets.
    ``remat`` (training only) recomputes each layer in the backward pass.
    Returns logits ``(B, P + S, V)`` (``K * V`` with codebooks),
    softcapped by ``cfg.final_logit_softcap``; with ``full`` a
    :class:`ForwardOut` (the logits, the ``moe`` layers' summed balance
    loss, the final hidden state)."""
    x = embed_lookup(params["embed"]["tok"], tokens, cfg)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    S = x.shape[1]
    off = torch.as_tensor(pos_offset, device=x.device)
    positions = (off[..., None] + torch.arange(S, device=x.device)).to(
        torch.int32)
    if positions.dim() > 1 and positions.shape[0] == 1:
        positions = positions[0]
    remat = remat and caches is None and torch.is_grad_enabled()
    shared = params.get("shared")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _in_mesh_context(_block) if remat else _block
    for kind, bp, c in layers(cfg, params, caches):
        if remat:
            # nothing in a block draws random numbers (its rounding is
            # deterministic), so the recompute gives the forward's values
            x, aux = checkpoint(block, kind, bp, x, cfg, qcfg, positions,
                                None, None, shared, use_reentrant=False)
        else:
            x, aux = _block(kind, bp, x, cfg, qcfg, positions, c,
                            block_tables, shared)
        if aux is not None:
            aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, qcfg, head)
    return ForwardOut(logits, aux_total, x) if full else logits


def _in_mesh_context(fn: Callable) -> Callable:
    """``fn`` run under the mesh and rules active now, wherever it is
    called later (a recompute in the backward may run on another
    thread, which would otherwise see no mesh and take rank-local
    scales)."""
    mesh = current_mesh()
    if mesh is None:
        return fn
    rules = current_rules()

    def run(*args):
        with shard_ctx(mesh, rules):
            return fn(*args)
    return run


def _logits(params, x: torch.Tensor, cfg: ArchConfig, qcfg,
            head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The head over ``x``, softcapped by ``cfg.final_logit_softcap``.
    Where the head holds this rank's vocabulary columns (a tied table's
    rows transposed, an untied head's column block) the logits are the
    rank's block, Q_E's scale the whole tensor's, and ``x``'s gradient is
    SUM-reduced over the model group (``collectives.sum_grad``)."""
    if head is None:
        head = lm_head(params, cfg)
    x = collectives.sum_grad(x, vocab_group(head.shape[-1], cfg))
    logits = qeinsum("bsd,dv->bsv", x, head, qcfg, out_axis="vocab")
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          group=None) -> torch.Tensor:
    """Mean next-token cross entropy in f32 over labels >= 0. Under a
    data-parallel mesh, this rank's share: its rows' sum over the global
    batch's label count.

    With ``group`` (``layers.vocab_group``) the logits are this rank's
    block of the vocabulary (block ``axis_index("vocab")``): the row max is
    MAX-reduced over the group, ``Σ exp(l - max)`` over the rank's block
    SUM-reduced, and the gold logit comes from the rank whose block holds
    the label (the others add 0; labels < 0 are masked as without a
    group). The SUMs are ``collectives.sum_forward``, so the backward
    gives ``softmax - onehot`` on the rank's columns. The one device's
    ``torch.logsumexp`` sums every column's exponential in one reduction;
    here each block is summed, then the blocks are summed in the
    collective's order, so ``logz`` may differ in its last bits."""
    lf = logits.to(torch.float32)
    if group is None:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])
        gold = gold[..., 0]
    else:
        n = lf.shape[-1]
        top = collectives.max_reduce(lf.detach().amax(dim=-1), group)
        sums = torch.exp(lf - top[..., None]).sum(dim=-1)
        logz = top + torch.log(collectives.sum_forward(sums, group))
        local = labels.long() - axis_index("vocab") * n
        inside = (local >= 0) & (local < n)
        gold = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = collectives.sum_forward(gold.masked_fill(~inside, 0.0),
                                       group)
    mask = (labels >= 0).to(torch.float32)
    count = collectives.sum_reduce(mask.sum().detach(), batch_group())
    return torch.sum((logz - gold) * mask) / torch.clamp_min(count, 1.0)


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            qcfg: Optional[QuantConfig] = None, *,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]``, plus 0.01 times the ``moe`` layers' balance loss
    and, with ``cfg.mtp_depth`` and ``params["mtp"]``, 0.3 times the MTP
    loss (:func:`_mtp_loss`), as the JAX package sums them. With
    ``batch["patches"]`` the patch positions are run and then dropped:
    the loss covers the text positions only. With K codebooks the
    logits ``(B, S, K * V)`` are read as ``(B, S, K, V)`` against labels
    ``(B, S, K)``, every codebook's every position weighted alike. Under a
    data-parallel mesh ``batch`` holds this rank's rows and the loss is
    its share of the global batch's (every term's sum over the global
    count): the shares sum to the one-device loss."""
    patches = batch.get("patches")
    tokens, labels = batch["tokens"], batch["labels"]
    out = forward(params, tokens, cfg, qcfg, patches=patches, remat=remat,
                  full=True)
    logits, hidden = out.logits, out.hidden
    if patches is not None:
        logits = logits[:, patches.shape[1]:]
        hidden = hidden[:, patches.shape[1]:]
    vocab = vocab_group(logits.shape[-1], cfg)
    if cfg.num_codebooks:
        if vocab is not None:
            raise NotImplementedError("a vocabulary split over the model "
                                      "group with codebooks")
        B, S, K = labels.shape
        logits = logits.reshape(B, S, K, cfg.vocab_size)
    loss = _xent(logits, labels, vocab) + 0.01 * out.aux
    if cfg.mtp_depth and "mtp" in params:
        loss = loss + 0.3 * _mtp_loss(params, hidden, tokens, labels, cfg,
                                      qcfg)
    return loss


def _mtp_loss(params, hidden: torch.Tensor, tokens: torch.Tensor,
              labels: torch.Tensor, cfg: ArchConfig, qcfg) -> torch.Tensor:
    """Depth-1 multi-token prediction (deepseek-v3), sharing the head:
    the trunk's final hidden state at t, normed, beside the embedding of
    token t + 1 (the last position's own), projected ``2d -> d`` and run
    through one ``dense`` block; the head's logits predict the labels
    shifted by one more position (the last one -1, no target)."""
    mtp = params["mtp"]
    emb = embed_lookup(params["embed"]["tok"], tokens, cfg)
    emb_next = torch.cat([emb[:, 1:], emb[:, -1:]], dim=1)
    h = rms_norm(hidden, mtp["norm"], cfg.norm_eps)
    x = qeinsum("bsd,dc->bsc", torch.cat([h, emb_next], dim=-1),
                dense_of(mtp["proj"], cfg), qcfg)
    positions = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    x, _ = _block("dense", mtp["block"], x, cfg, qcfg, positions, None, None)
    shifted = torch.cat([labels[:, 1:], -torch.ones_like(labels[:, :1])],
                        dim=1)
    logits = _logits(params, x, cfg, qcfg)
    return _xent(logits, shifted, vocab_group(logits.shape[-1], cfg))


def init_caches(batch: int, max_len: int, cfg: ArchConfig, *,
                page_size: Optional[int] = None,
                num_pages: Optional[int] = None, window_slack: int = 0,
                device=None):
    """Decode caches shaped like the trunk (``prefix`` list, ``period``
    stacks): a ``local`` layer gets a ring of ``sliding_window +
    window_slack`` positions (at most ``max_len``); a full-context layer
    (``shared_attn`` too) a dense ``(batch, max_len)`` buffer, or with
    ``page_size`` a paged pool (default ``batch * ceil(max_len /
    page_size)`` pages); an MLA layer (any attention kind under
    ``cfg.use_mla``) its latent cache, never paged; a ``mamba`` or
    ``rwkv`` layer its f32 state dict, which has no cursor ``idx``.
    Speculative decoding passes its k as ``window_slack``: draft writes
    past a rewound cursor then land only on ring slots no query can see
    any more.

    Under a mesh each leaf is this rank's shard
    (``params_sharding.cache_local_shape``). The serving rules shard the
    KV caches and pools by ``kv_heads`` and replicate MLA's latent cache
    and every recurrent state: the serving rules keep ``ssm_inner``
    whole, so each rank runs the whole Mamba2 mixer and WKV and holds the
    whole ``ssm``/``S``/``conv_*``/``shift_*`` rows, equal to one card's
    (JAX's cache table names ``act_heads`` for ``ssm`` and ``S``, a GSPMD
    placement that changes no value). The decode rules
    (``sharding.decode_rules``) also split every leaf's rows where they
    split ``batch``, and a dense KV cache or MLA latent by position where
    ``kv_seq`` resolves: the rank holds one contiguous block of
    ``max_len / n`` positions (block ``axis_index("kv_seq")``) and every
    KV head; rings keep their slots and recurrent state its heads."""
    dev = resolve_device(device)
    prefix, n_periods, period = cfg.layer_pattern()
    if page_size is not None and num_pages is None:
        num_pages = batch * (-(-max_len // page_size))
    hd = cfg.head_dim
    rows = cache_local_shape((batch,), "idx")[0]

    def one(kind):
        if kind == "mamba":
            return ssm_mod.init_mamba_state(rows, cfg, dev)
        if kind == "rwkv":
            return rwkv_mod.init_rwkv_state(rows, cfg, dev)
        if cfg.use_mla and kind in ("dense", "global", "moe"):
            _, cap, _ = cache_local_shape(
                (batch, max_len, cfg.kv_lora_rank), "c_kv", kind)
            return attn_mod.init_mla_cache(rows, cap, cfg, dev)
        if kind == "local":
            ring = min(cfg.sliding_window + window_slack, max_len)
            kv = cache_local_shape((batch, ring, cfg.num_kv_heads, hd), "k",
                                   kind)[2]
            return attn_mod.init_kv_cache(rows, ring, cfg, dev, window=ring,
                                          kv_heads=kv)
        if page_size is not None:
            kv = cache_local_shape((num_pages + 1, page_size,
                                    cfg.num_kv_heads, hd), "kp", kind)[2]
            return attn_mod.init_paged_kv_cache(rows, num_pages, page_size,
                                                cfg, dev, kv_heads=kv)
        _, cap, kv, _ = cache_local_shape(
            (batch, max_len, cfg.num_kv_heads, hd), "k", kind)
        return attn_mod.init_kv_cache(rows, cap, cfg, dev, kv_heads=kv)

    caches: Dict[str, Any] = {}
    if prefix:
        caches["prefix"] = [one(k) for k in prefix]
    if n_periods:
        caches["period"] = {
            f"pos{j}": {k: v.unsqueeze(0).repeat((n_periods,)
                                                 + (1,) * v.dim())
                        for k, v in one(kind).items()}
            for j, kind in enumerate(period)}
    return caches


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
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
