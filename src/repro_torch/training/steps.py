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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.lns import LNSFormat, is_lns_weight
from repro_torch.core.quantizer import QuantConfig, quantize_grads
from repro_torch.device import resolve_device
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import init_params, lm_loss
from repro_torch.obs.numerics import grad_encode_stats
from repro_torch.optim.madam import (MadamConfig, MadamState, attach_proxies,
                                     grad_proxies, init_lns_params, madam_lns)
from repro_torch.tree import leaves, tree_map

__all__ = ["TrainState", "init_train_state", "build_train_step",
           "batch_to_device"]


class TrainState(NamedTuple):
    params: Any        # packed LNSWeight and f32 leaves
    opt: MadamState
    step: int


def init_train_state(cfg: ArchConfig, mcfg: MadamConfig, *, seed: int = 0,
                     device=None) -> TrainState:
    """Random parameters (``models.model.init_params``), encoded straight
    into the update store, and a fresh optimizer state, on ``device``
    (default CUDA)."""
    dev = resolve_device(device)
    params = init_lns_params(init_params(cfg, seed=seed, device=dev), mcfg)
    init_opt, _ = madam_lns(mcfg)
    return TrainState(params=params, opt=init_opt(params), step=0)


def _device_of(params) -> torch.device:
    for _, leaf in leaves(params):
        return leaf.packed.device if is_lns_weight(leaf) else leaf.device
    raise ValueError("empty parameter tree")


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A ``SyntheticLM`` batch (numpy) as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def build_train_step(cfg: ArchConfig, qcfg: Optional[QuantConfig],
                     mcfg: MadamConfig, *, accum_steps: int = 1,
                     numerics: bool = False) -> Callable:
    """``train_step(state, batch, generator=None) -> (state, metrics)``:
    ``metrics`` holds ``loss`` and ``grad_norm`` (0-d tensors) and
    ``step`` (an int), and with ``numerics`` a ``"numerics"`` dict of
    per-layer update-site (K4's epilogue) and gradient-encode stats. The
    batch is moved to the parameters' device. ``generator`` is needed only
    for a stochastic Q_U. An LNS Q_U (``qcfg.update``) must be the store
    the optimizer steps, ``mcfg.update_format``. A miniature-float Q_U
    (``QuantConfig.fp8()``'s FP16) is not read, as in the JAX package,
    whose step never reads ``qcfg.update``: the weights stay in Madam's
    LNS store and K3 steps them on that path too."""
    q_u = getattr(qcfg, "update", None)
    if isinstance(q_u, LNSFormat) and q_u != mcfg.update_format:
        raise ValueError(f"Q_U {q_u} differs from the optimizer's store "
                         f"{mcfg.update_format}")
    _, opt_update = madam_lns(mcfg)
    # the forward re-grid target of the requant clip stat
    fwd_fmt = getattr(qcfg, "weight", None) if numerics else None
    if not isinstance(fwd_fmt, LNSFormat):
        fwd_fmt = None

    def one_microbatch(params, mb):
        proxies = grad_proxies(params, cfg.compute_dtype)
        loss = lm_loss(attach_proxies(params, proxies), mb, cfg, qcfg)
        loss.backward()
        grads = tree_map(lambda d: d.grad, proxies)
        # encode-site stats read the raw gradients Q_G is about to encode
        enc = grad_encode_stats(grads, qcfg) if numerics else {}
        return loss.detach(), quantize_grads(grads, qcfg), enc

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        params = state.params
        batch = batch_to_device(batch, _device_of(params))
        if accum_steps == 1:
            loss, grads, enc_stats = one_microbatch(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch {n} does not split into "
                                 f"{accum_steps} microbatches")
            mbs = [{k: v.chunk(accum_steps)[i] for k, v in batch.items()}
                   for i in range(accum_steps)]
            encs = []
            for i, mb in enumerate(mbs):
                l_i, g_i, e_i = one_microbatch(params, mb)
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
            if numerics:
                new_params, new_opt, upd_stats = opt_update(
                    grads, state.opt, params, generator, with_stats=True,
                    requant_fmt=fwd_fmt)
            else:
                new_params, new_opt = opt_update(grads, state.opt, params,
                                                 generator)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(
                g.to(torch.float32))) for _, g in leaves(grads)))
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        if numerics:
            metrics["numerics"] = {"update": upd_stats,
                                   "grad_encode": enc_stats}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step

