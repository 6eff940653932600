"""The LNS-native train step (paper Fig. 3), as ``repro.training.steps``.

1. The parameters stay packed LNS words end to end: routed GEMMs read the
   words through the kernels, the other uses decode per leaf; there is no
   dense master copy.
2. Forward and backward run with Q_A/Q_W and Q_E; gradients are taken
   w.r.t. zero ``delta`` carriers (``grad_proxies``), whose gradient is
   dL/dW at W = decode(packed).
3. Q_G quantizes the weight gradients.
4. The fused Madam update steps the packed exponent words (K3, or K4 with
   ``numerics``) in one pass per leaf.

``accum_steps > 1`` runs the microbatches one after another and sums
their quantized gradients, as the JAX package's scan does.

Data parallelism (a mesh whose rules split ``batch``, active when the
step is built): parameters and optimizer state are
replicated, and the step computes the one-device step on the global
batch. The global batch is cut into microbatches first (microbatch i is
global rows ``[i·B/A, (i+1)·B/A)``), then each into this rank's rows
(``params_sharding.batch_rows``), where the batch lies: only the rank's
rows go to its card. Each rank's loss is its share of the
global loss, its Q_A and Q_E scales are the global batch's
(``core.quantizer``); after each microbatch's backward the gradients and
the loss are SUM-reduced in f32 buckets
(``collectives.sum_tensors``), and only then does Q_G quantize them, as
the reference applies Q_G to the global microbatch gradient. The grad
norm and K3 (or K4) run replicated on the reduced gradients, so every
rank steps to the same words. A stochastic Q_U needs the same
generator seed on every rank (checked at the first step). ``remat`` (on
by default, as in the JAX package) recomputes each layer's forward in the
backward pass (``torch.utils.checkpoint``): nothing inside a layer draws
random numbers, so the recompute repeats the forward bit for bit and the
loss, gradients and words are the same as without it; it reissues the
forward's collectives, in the forward's order, on every rank.

Tensor parallelism (the dense family on a mesh whose ``model`` axis is
larger than 1, under ``sharding.data_rules`` or ``sharding.train_rules``):
the rows split over the data axes as above. Under ``data_rules`` the
weights sit where the serving rules put them: each column-parallel leaf
(``wq``/``wk``/``wv`` and their biases where the head counts divide the
axis, ``up``/``gate`` where ``d_ff`` does) holds this rank's columns,
every other leaf is whole on every rank. Under ``train_rules``, JAX's
training placement, ``wo`` and ``down`` also hold this rank's rows where
their column-parallel partners are split, and ``tok`` (an untied
``head``) its vocabulary rows (columns) where the vocabulary divides the
axis; the forward SUM-reduces each row block's partial product and takes
the cross entropy over the logits' vocabulary blocks
(``collectives.sum_forward``). The state is the rank's shard of the
one-device state (``init_train_state(shard=)``, or
:func:`shard_train_state` of a whole one); the second moments follow
their words. Under ``data_rules`` the forward is
``build_prefill_step``'s placement. The backward passes through the
model group's collectives (``collectives.gather_with_grad``,
``sum_grad`` and ``sum_forward``). Gradients reduce by leaf: every leaf
SUMs over the data group; a shard's gradient stays a shard, and Q_G's
per-tensor scale is the whole leaf's (max-reduced over its shard group);
the grad norm sums the shards' squares over their group and counts each
whole leaf once. K3 (K4) steps each rank's shard, so a whole leaf steps to
the same words on every rank of a model group. The observed step's
per-leaf statistics are whole-leaf means (each a mean of its shard's
elements, the shards equal in size, so SUM-reduced over the shard group
and divided by its size).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.lns import LNSFormat, is_lns_weight
from repro_torch.core.quantizer import QuantConfig, quantize_grads
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.params_sharding import (batch_rows,
                                                     shard_tree, split_axes)
from repro_torch.distributed.sharding import (batch_group, current_mesh,
                                              current_rules, data_rules,
                                              decode_rules, model_axis_size,
                                              shard_ctx, train_rules)
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import (decode_step, forward, init_params,
                                     lm_loss)
from repro_torch.obs.numerics import grad_encode_stats, path_name
from repro_torch.optim.madam import (MadamConfig, MadamState, attach_proxies,
                                     grad_proxies, lns_leaf_encoder,
                                     madam_lns)
from repro_torch.tree import leaves, tree_map

__all__ = ["TrainState", "init_train_state", "shard_train_state",
           "build_train_step", "build_prefill_step", "build_decode_step",
           "batch_to_device", "TP_FAMILIES"]

# the families whose train step runs tensor-parallel (model > 1); the
# others raise there (ROADMAP 7j)
TP_FAMILIES = ("dense",)


class TrainState(NamedTuple):
    params: Any        # packed LNSWeight and f32 leaves
    opt: MadamState
    step: int


def init_train_state(cfg: ArchConfig, mcfg: MadamConfig, *, seed: int = 0,
                     device=None, shard=None) -> TrainState:
    """Random parameters (``models.model.init_params``), each leaf encoded
    into the update store as it is drawn, and a fresh optimizer state, on
    ``device`` (default CUDA). ``shard`` (a
    ``distributed.params_sharding.LocalShard`` under the step's mesh and
    rules) keeps this rank's shard of each leaf as soon as it is encoded,
    so the words and the second moments made beside them are the rank's
    shard of the one-device state (tensor-parallel training)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev,
                         leaf_fn=lns_leaf_encoder(mcfg), shard=shard)
    init_opt, _ = madam_lns(mcfg)
    return TrainState(params=params, opt=init_opt(params), step=0)


def shard_train_state(state: TrainState, mesh, rules=None) -> TrainState:
    """This rank's shard of a whole train state (a carried one): the
    words and the second moments sliced by the placement of ``rules``
    under ``mesh`` (``params_sharding.shard_tree``: the serving
    placement under ``data_rules``, JAX's training placement under
    ``train_rules``)."""
    return TrainState(
        params=shard_tree(state.params, mesh, rules),
        opt=type(state.opt)(g2=shard_tree(state.opt.g2, mesh, rules),
                            count=state.opt.count),
        step=state.step)


def _device_of(params) -> torch.device:
    for _, leaf in leaves(params):
        return leaf.packed.device if is_lns_weight(leaf) else leaf.device
    raise ValueError("empty parameter tree")


def _as_tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``SyntheticLM`` batch (numpy) as tensors where they lie."""
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in batch.items()}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A ``SyntheticLM`` batch (numpy) as tensors on ``device``."""
    return {k: v.to(device) for k, v in _as_tensors(batch).items()}


def _same_seed(generator: torch.Generator, group, device) -> None:
    """Raise unless every rank's generator has this rank's seed (two MAX
    reduces: of the seed and of its negation)."""
    seed = generator.initial_seed() & ((1 << 62) - 1)
    t = torch.tensor([seed, -seed], dtype=torch.int64, device=device)
    m = collectives.max_reduce(t, group)
    if m.device.type == "meta":     # a dry run: the reduce, no host read
        return
    if int(m[0]) != seed or int(m[1]) != -seed:
        raise ValueError("a stochastic Q_U needs the same generator seed "
                         "on every data-parallel rank")


def build_train_step(cfg: ArchConfig, qcfg: Optional[QuantConfig],
                     mcfg: MadamConfig, *, accum_steps: int = 1,
                     remat: bool = True, numerics: bool = False) -> Callable:
    """``train_step(state, batch, generator=None) -> (state, metrics)``:
    ``metrics`` holds ``loss`` and ``grad_norm`` (0-d tensors) and
    ``step`` (an int), and with ``numerics`` a ``"numerics"`` dict of
    per-layer update-site (K4's epilogue) and gradient-encode stats. The
    batch is moved to the parameters' device. ``generator`` is needed only
    for a stochastic Q_U. An LNS Q_U (``qcfg.update``) must be the store
    the optimizer steps, ``mcfg.update_format``. A miniature-float Q_U
    (``QuantConfig.fp8()``'s FP16) is not read, as in the JAX package,
    whose step never reads ``qcfg.update``: the weights stay in Madam's
    LNS store and K3 steps them on that path too.

    Built under a data-parallel mesh (``shard_ctx``), it is the
    data-parallel step: ``batch`` is the global batch on every rank, and
    the step runs under that mesh and its rules wherever it is called,
    moving only this rank's rows to the card. Built under a mesh whose
    ``model`` axis is larger than 1 and ``sharding.data_rules(cfg,
    mesh)`` or ``sharding.train_rules(cfg, mesh)``, it is the
    tensor-parallel step of the module docstring, on the rank's shard of
    the state; only the dense family runs there (the
    others raise: ROADMAP 7j), with per-tensor Q_E and Q_G scales and
    unfactored, round-to-nearest Madam."""
    q_u = getattr(qcfg, "update", None)
    if isinstance(q_u, LNSFormat) and q_u != mcfg.update_format:
        raise ValueError(f"Q_U {q_u} differs from the optimizer's store "
                         f"{mcfg.update_format}")
    _, opt_update = madam_lns(mcfg)
    # the forward re-grid target of the requant clip stat
    fwd_fmt = getattr(qcfg, "weight", None) if numerics else None
    if not isinstance(fwd_fmt, LNSFormat):
        fwd_fmt = None

    mesh = current_mesh()
    rules = current_rules()
    if mesh is not None and model_axis_size(mesh) > 1:
        _check_tensor_parallel(cfg, qcfg, mcfg, mesh, rules)
    seed_checked = []
    shard_groups = []     # the leaves' shard groups, made at the first step

    def groups_of(params):
        """The tree of each leaf's shard group (None: whole on every
        rank) under the step's mesh and rules."""
        if not shard_groups:
            if mesh is None or model_axis_size(mesh) == 1:
                axes = tree_map(lambda p: (), params)
            else:
                axes = split_axes(params, mesh, rules)
            shard_groups.append(tree_map(
                lambda a: mesh.group(a) if a else None, axes))
        return shard_groups[0]

    def one_microbatch(params, mb, group, groups):
        proxies = grad_proxies(params, cfg.compute_dtype)
        loss = lm_loss(attach_proxies(params, proxies), mb, cfg, qcfg,
                       remat=remat)
        loss.backward()
        grads = tree_map(lambda d: d.grad, proxies)
        loss = loss.detach()
        if group is not None:
            # the ranks' shares summed: the global microbatch's loss and
            # gradient, the loss riding in the gradients' first bucket
            box = loss.reshape(1).to(torch.float32)
            collectives.sum_tensors([box] + [g for _, g in leaves(grads)],
                                    group)
            loss = box[0]
        # encode-site stats read the raw gradients Q_G is about to encode
        enc = (_whole_leaf(grad_encode_stats(grads, qcfg, groups), groups)
               if numerics else {})
        return loss, quantize_grads(grads, qcfg, groups), enc

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        ctx = (shard_ctx(mesh, rules) if mesh is not None
               else contextlib.nullcontext())
        with ctx:
            return _train_step(state, batch, generator)

    def _train_step(state, batch, generator):
        params = state.params
        group = batch_group()
        groups = groups_of(params)
        device = _device_of(params)
        batch = _as_tensors(batch)
        if group is not None and generator is not None and not seed_checked:
            _same_seed(generator, group, device)
            seed_checked.append(True)
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into "
                             f"{accum_steps} microbatches")
        # the global batch's microbatches, then this rank's rows of each
        mbs = ([batch] if accum_steps == 1 else
               [{k: v.chunk(accum_steps)[i] for k, v in batch.items()}
                for i in range(accum_steps)])
        if group is not None:
            mbs = [batch_rows(mb, mesh) for mb in mbs]
        mbs = [batch_to_device(mb, device) for mb in mbs]
        if accum_steps == 1:
            loss, grads, enc_stats = one_microbatch(params, mbs[0], group,
                                                    groups)
        else:
            encs = []
            for i, mb in enumerate(mbs):
                l_i, g_i, e_i = one_microbatch(params, mb, group, groups)
                if i == 0:   # the sums run in f32, as the JAX scan's carry
                    loss = l_i.to(torch.float32)
                    grads = tree_map(lambda g: g.to(torch.float32), g_i)
                else:
                    loss = loss + l_i
                    grads = tree_map(torch.add, grads, g_i)
                encs.append(e_i)
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
            enc_stats = tree_map(lambda *xs: torch.stack(xs).mean(dim=0),
                                 *encs)
        with torch.no_grad():
            # the norm's f32 temporaries come and go before the update
            # allocates the new words and moments
            gnorm = _grad_norm(grads, groups)
            if numerics:
                new_params, new_opt, upd_stats = opt_update(
                    grads, state.opt, params, generator, with_stats=True,
                    requant_fmt=fwd_fmt)
                upd_stats = _whole_leaf(upd_stats, groups)
            else:
                new_params, new_opt = opt_update(grads, state.opt, params,
                                                 generator)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        if numerics:
            metrics["numerics"] = {"update": upd_stats,
                                   "grad_encode": enc_stats}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def _check_tensor_parallel(cfg: ArchConfig, qcfg, mcfg: MadamConfig, mesh,
                           rules) -> None:
    """Raise unless this step can run tensor-parallel (the module
    docstring): a family whose backward is ported, the placement its
    state was sharded by, per-tensor Q_E/Q_G scales (a per-row or
    per-column scale of a column shard would need another reduce) and
    an unfactored, round-to-nearest update (a factored moment's row
    marginal and a stochastic draw span a leaf's every column)."""
    m = model_axis_size(mesh)
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"tensor-parallel training of the {cfg.family!r} family "
            f"(model = {m}) is not ported: only the dense family trains "
            f"on a (data, model) mesh (ROADMAP 7j)")
    offs = [sorted(k for k, v in want.items() if rules.get(k) != v)
            for want in (data_rules(cfg, mesh), train_rules(cfg, mesh))]
    if all(offs):
        raise ValueError(f"tensor-parallel training runs under "
                         f"sharding.data_rules(cfg, mesh) or "
                         f"sharding.train_rules(cfg, mesh); the active "
                         f"rules differ from data_rules on {offs[0]} and "
                         f"from train_rules on {offs[1]}")
    if qcfg is not None and (qcfg.err_scale_axis is not None
                             or qcfg.grad_scale_axis is not None):
        raise ValueError("tensor-parallel training takes per-tensor Q_E "
                         "and Q_G scales")
    if mcfg.factored or mcfg.stochastic:
        raise ValueError("tensor-parallel training steps unfactored, "
                         "round-to-nearest Madam")


def _grad_norm(grads, groups) -> torch.Tensor:
    """The global grad norm in f32: each whole leaf's squares once, each
    shard's squares SUM-reduced over its shard group (in the tree's
    order, the same on every rank)."""
    pairs = [(g, gr) for (_, g), (_, gr) in zip(leaves(grads),
                                                leaves(groups))]
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g, gr in pairs if gr is None)
    split: Dict[Any, torch.Tensor] = {}
    for g, gr in pairs:
        if gr is not None:
            part = torch.sum(torch.square(g.to(torch.float32)))
            split[gr] = part if gr not in split else split[gr] + part
    for gr, part in split.items():
        sq = sq + collectives.sum_reduce(part, gr)
    return torch.sqrt(sq)


def _whole_leaf(stats: Dict[str, Dict[str, torch.Tensor]],
                groups) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-leaf statistics (keyed by ``obs.numerics.path_name``) of the
    leaves split over a group made whole: every statistic here is a mean
    over a leaf's elements (the K4 and encode-site fractions, the mean
    code, the mean log2 scale), and the shards are equal in size, so
    the whole leaf's is the shards' sum over the group over its size.
    A whole leaf's stats are its own."""
    by_name = {path_name(p): gr for p, gr in leaves(groups)}
    out = {}
    for name, st in stats.items():
        gr = by_name.get(name)
        if gr is None:
            out[name] = st
            continue
        keys = list(st)
        vec = torch.stack([st[k].to(torch.float32) for k in keys])
        vec = collectives.sum_reduce(vec, gr) / collectives.group_size(gr)
        out[name] = dict(zip(keys, vec.unbind()))
    return out

def build_prefill_step(cfg: ArchConfig, qcfg: Optional[QuantConfig],
                       mcfg: Optional[MadamConfig] = None, *, mesh=None,
                       rules: Optional[Dict[str, Any]] = None) -> Callable:
    """``prefill(params, batch) -> last-position logits``: the packed
    leaves as they are (routed GEMMs through the kernels, a per-leaf
    decode elsewhere), the training attention over the whole prompt, no
    cache written, no graph recorded. ``mcfg`` is taken for the JAX
    signature's sake.

    With ``mesh`` the step runs under ``mesh`` and ``rules`` (default
    ``sharding.data_rules(cfg, mesh)``: rows over the data axes, weights
    on the serving rules), and ``params`` are this rank's
    (``LocalShard`` or ``shard_tree`` under the same rules). ``batch`` is
    the global batch; the step takes this rank's rows
    (``params_sharding.batch_rows``) and returns their logits. Q_A's
    per-tensor scales are MAX-reduced over the ranks the rows split over
    (``quantizer.act_stat``), so a rank's rows are quantized with the
    whole batch's scale, as on one device (ROADMAP H7)."""
    del mcfg
    if mesh is not None and rules is None:
        rules = data_rules(cfg, mesh)

    def prefill_step(params, batch):
        batch = batch_to_device(batch, _device_of(params))
        with torch.no_grad():
            logits = forward(params, batch["tokens"], cfg, qcfg,
                             patches=batch.get("patches"))
        return logits[:, -1]

    if mesh is None:
        return prefill_step

    def sharded_step(params, batch):
        with shard_ctx(mesh, rules):
            return prefill_step(params, batch_rows(_as_tensors(batch),
                                                   mesh))

    return sharded_step


def build_decode_step(cfg: ArchConfig, qcfg: Optional[QuantConfig],
                      mcfg: Optional[MadamConfig] = None, *, mesh=None,
                      rules: Optional[Dict[str, Any]] = None) -> Callable:
    """``decode(params, caches, batch, pos) -> (logits, caches)``: the
    tokens of ``batch["tokens"]`` appended at ``pos`` (a scalar or a
    ``(B,)`` row of offsets) through ``batch.get("block_tables")``; the
    caches are updated in place and returned, as the JAX step returns its
    new ones.

    With ``mesh`` the step runs under ``mesh`` and ``rules`` (default
    ``sharding.decode_rules(cfg, mesh)``: split-KV decode), and
    ``params`` and ``caches`` are this rank's (``LocalShard`` and
    ``init_caches`` under the same rules). ``batch`` and a ``(B,)``
    ``pos`` are the global batch's; the step takes this rank's rows
    (``params_sharding.batch_rows``) and returns their logits. Q_A's
    per-tensor scales are MAX-reduced over the ranks the rows split over
    (``quantizer.global_stat``), so a rank's rows are quantized with the
    whole batch's scale, as on one device (ROADMAP H7)."""
    del mcfg
    if mesh is not None and rules is None:
        rules = decode_rules(cfg, mesh)

    def step(params, caches, batch, pos):
        batch = batch_to_device(batch, _device_of(params))
        with torch.no_grad():
            logits = decode_step(params, caches, batch["tokens"], cfg, qcfg,
                                 pos_offset=pos,
                                 block_tables=batch.get("block_tables"))
        return logits, caches

    if mesh is None:
        return step

    def serve_step(params, caches, batch, pos):
        with shard_ctx(mesh, rules):
            batch = _as_tensors(batch)
            if isinstance(pos, torch.Tensor) and pos.dim():
                batch = dict(batch, _pos=pos)
            batch = batch_rows(batch, mesh)
            pos = batch.pop("_pos", pos)
            return step(params, caches, batch, pos)

    return serve_step
