"""Madam on LNS (paper §4, Algorithm 1), as in ``repro.optim.madam``.

Weights live permanently as packed LNS words: there is no floating-point
master copy, and the multiplicative update is an integer add on the
exponent,

    code <- clamp(round(code + lr·γ_U·(g/sqrt(v̂))·sign(W)), 0, 2^(B_U-1)-1)

with the sign bit never touched. Every packed leaf of rank >= 2 takes the
fused step of ``kernels.dispatch.madam_step`` (K3, or K4 with the
numerics stats): one pass over (word, grad, v). The factored and
stochastic variants, and packed leaves of rank < 2, take
:func:`madam_lns`'s plain-torch leaf update on either device, as the JAX
package takes its jnp reference there. Leaves that are not packed (norm
gains) take a full-precision Madam step.

Gradients come from zero ``delta`` carriers (:func:`grad_proxies`): their
gradient is dL/dW at W = decode(packed).

Trees are nested dicts; a factored second moment is a ``{"r", "c"}`` dict
at its leaf's path, so leaves are walked by the parameter tree's paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.lns import (LNSFormat, LNSWeight, is_lns_weight,
                                  lns_pack, lns_unpack, lns_weight_encode)
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.madam_stats import (madam_stats_dict,
                                             madam_stats_vec, requant_spec)
from repro_torch.numerics.rounding import round_nearest, stochastic_round
from repro_torch.obs.numerics import path_name
from repro_torch.tree import leaves, tree_get, tree_map, tree_set

__all__ = ["MadamConfig", "MadamState", "init_lns_params", "materialize",
           "grad_proxies", "attach_proxies", "madam_lns", "madam_fp"]


@dataclasses.dataclass(frozen=True)
class MadamConfig:
    """Algorithm-1 settings (paper defaults lr=2^-7, beta=0.999).
    ``update_format`` is the store the weights live in (16-bit by default,
    8-bit to serve on the forward grid). ``factored`` keeps Adafactor-style
    row and column second moments for >=2-D leaves; ``stochastic`` rounds
    the exponent stochastically (the Q_U option); ``fp_lr`` and
    ``fp_clip`` are the step size and clamp of the full-precision
    leaves."""

    lr: float = 2.0 ** -7
    beta: float = 0.999
    update_format: LNSFormat = LNSFormat(bits=16, gamma=8 * (1 << 8))
    stochastic: bool = False
    eps: float = 1e-30
    fp_lr: Optional[float] = None
    fp_clip: float = 10.0
    factored: bool = False

    def __post_init__(self):
        if self.update_format.bits < 2:
            raise ValueError("update_format.bits must be >= 2")


class MadamState(NamedTuple):
    g2: Any       # second moments (f32), a tree shaped like the params
    count: int    # steps taken: a host int, so no device sync reads it


def _lns_leaf_filter(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    """>=2-D tensors live in LNS, 1-D gains stay f32. A stacked ``period``
    leaf's leading layer axis does not count toward the rank."""
    stacked = "period" in path
    return leaf.dim() - (1 if stacked else 0) >= 2


def init_lns_params(params, cfg: MadamConfig,
                    leaf_filter: Callable = _lns_leaf_filter):
    """Encode a dense tree into packed :class:`LNSWeight` and f32 leaves.
    Every axis but the contraction axis (-2) keeps its own scale, so a
    stacked weight gets per-layer, per-output-channel scales that factor
    out of the routed GEMM."""
    fmt = cfg.update_format

    def enc(path, w):
        if isinstance(w, dict):
            return {k: enc(path + (k,), v) for k, v in w.items()}
        if not leaf_filter(path, w):
            return w.to(torch.float32)
        ax = tuple(i for i in range(w.dim()) if i != w.dim() - 2)
        return lns_weight_encode(w, fmt, scale_axis=ax)

    return enc((), params)


def materialize(params, dtype=torch.bfloat16):
    """Decode the packed leaves to dense tensors (export and tests; the
    train and serve paths read packed leaves directly)."""
    return tree_map(lambda p: p.decode(dtype) if is_lns_weight(p) else p, params)


def grad_proxies(params, dtype=torch.bfloat16):
    """The leaves to differentiate: a zero ``dtype`` carrier with
    ``requires_grad`` per packed leaf, and each f32 leaf itself (detached,
    with ``requires_grad``)."""
    def proxy(p):
        if is_lns_weight(p):
            return torch.zeros(p.shape, dtype=dtype, device=p.packed.device,
                               requires_grad=True)
        return p.detach().requires_grad_(True)

    return tree_map(proxy, params)


def attach_proxies(params, proxies):
    """The tree a loss runs on: packed leaves with their carrier as
    ``delta``, f32 leaves replaced by their proxies."""
    return tree_map(lambda p, d: p.replace(delta=d) if is_lns_weight(p)
                    else d, params, proxies)


def madam_lns(cfg: MadamConfig):
    """The ``(init, update)`` pair of LNS-native Madam.

    ``update(grads, state, params, generator=None, *, with_stats=False,
    requant_fmt=None)`` takes gradients w.r.t. the decoded weights (the
    :func:`grad_proxies` gradients) and returns ``(params, state)``, plus
    a dict of per-leaf stats with ``with_stats``. ``generator`` drives the
    stochastic rounding and is required when ``cfg.stochastic``."""

    def _v_init(p):
        shape = tuple(p.shape)
        dev = p.packed.device if is_lns_weight(p) else p.device
        if cfg.factored and len(shape) >= 2:
            return {"r": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=dev),
                    "c": torch.zeros(shape[:-2] + shape[-1:],
                                     dtype=torch.float32, device=dev)}
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def _v_update(g, v):
        """EMA update -> (new v, dense v-hat)."""
        if isinstance(v, dict):
            r = cfg.beta * v["r"] + (1.0 - cfg.beta) * torch.mean(g * g, -1)
            c = cfg.beta * v["c"] + (1.0 - cfg.beta) * torch.mean(g * g, -2)
            denom = torch.clamp_min(torch.mean(r, -1, keepdim=True), 1e-30)
            vhat = r[..., None] * c[..., None, :] / denom[..., None]
            return {"r": r, "c": c}, vhat
        nv = (1.0 - cfg.beta) * g * g + cfg.beta * v
        return nv, nv

    def _lns_leaf_reference(p: LNSWeight, g, v, gen, bc, *, requant=None,
                            with_stats=False):
        """Factored v-hat and/or a stochastic exponent round."""
        leaf_fmt = p.fmt
        v, vhat = _v_update(g, v)
        gstar = g * torch.rsqrt(vhat / bc + cfg.eps)
        sign, code = lns_unpack(p.packed, leaf_fmt)
        step = cfg.lr * leaf_fmt.gamma * gstar * sign.to(torch.float32)
        target = code.to(torch.float32) + step
        rounded = (stochastic_round(target, gen) if cfg.stochastic
                   else round_nearest(target))
        new_code = torch.clamp(rounded, 0, leaf_fmt.max_code)
        np_ = p.replace(packed=lns_pack(sign, new_code, leaf_fmt))
        if not with_stats:
            return np_, v, None
        vec = madam_stats_vec(code, target, new_code, gamma=leaf_fmt.gamma,
                              max_code=leaf_fmt.max_code, requant=requant)
        return np_, v, madam_stats_dict(vec, code.numel(), leaf_fmt)

    def init(params) -> MadamState:
        return MadamState(g2=tree_map(_v_init, params), count=0)

    def update(grads, state: MadamState, params,
               generator: Optional[torch.Generator] = None, *,
               with_stats: bool = False,
               requant_fmt: Optional[LNSFormat] = None):
        count = state.count + 1
        bc = ref.bias_correction(cfg.beta, count)
        if cfg.stochastic and generator is None:
            raise ValueError("stochastic Q_U requires a torch.Generator")
        stats = {} if with_stats else None
        new_p: Dict = {}
        new_v: Dict = {}
        for path, p in leaves(params):
            g = tree_get(grads, path)
            v = tree_get(state.g2, path)
            if is_lns_weight(p):
                leaf_stats = None
                if cfg.stochastic or isinstance(v, dict) or p.ndim < 2:
                    np_, nv, leaf_stats = _lns_leaf_reference(
                        p, g.to(torch.float32), v, generator, bc,
                        requant=requant_spec(p.fmt, requant_fmt),
                        with_stats=with_stats)
                elif with_stats:
                    pk, nv, leaf_stats = dispatch.madam_step(
                        p.packed, g, v, count, p.fmt, lr=cfg.lr,
                        beta=cfg.beta, eps=cfg.eps, with_stats=True,
                        requant_fmt=requant_fmt)
                    np_ = p.replace(packed=pk)
                else:
                    pk, nv = dispatch.madam_step(
                        p.packed, g, v, count, p.fmt, lr=cfg.lr,
                        beta=cfg.beta, eps=cfg.eps)
                    np_ = p.replace(packed=pk)
                if with_stats:
                    leaf_stats["scale_log2"] = torch.log2(
                        p.scale.to(torch.float32)).mean()
                    stats[path_name(path)] = leaf_stats
            else:
                # full-precision Madam for norm gains (the paper's carve-out)
                g = g.to(torch.float32)
                nv, vhat = _v_update(g, v)
                gstar = g * torch.rsqrt(vhat / bc + cfg.eps)
                lr = cfg.fp_lr if cfg.fp_lr is not None else cfg.lr
                w = p * torch.exp(-lr * torch.sign(p) * gstar)
                # an additive floor lets a zero gain leave zero
                w = torch.where(p.abs() < 1e-8, p - lr * gstar * 1e-8, w)
                np_ = torch.clamp(w, -cfg.fp_clip, cfg.fp_clip)
            tree_set(new_p, path, np_)
            tree_set(new_v, path, nv)
        out = (new_p, MadamState(g2=new_v, count=count))
        return out + (stats,) if with_stats else out

    return init, update


def madam_fp(lr: float = 2.0 ** -7, beta: float = 0.999, clip: float = 10.0,
             eps: float = 1e-30):
    """Full-precision Madam (Eq. 9) over a tree of dense tensors: the
    paper's pre-quantization baseline and the Fig.-7 anchor. The
    ``(init, update)`` pair; ``update(grads, state, params,
    generator=None)`` returns ``(params, state)``, each leaf stepped in
    f32 as ``p·exp(-lr·sign(p)·g/sqrt(v̂ + eps))``, clamped to ±``clip``
    and cast back to its dtype."""

    def init(params) -> MadamState:
        return MadamState(g2=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params), count=0)

    @torch.no_grad()
    def update(grads, state: MadamState, params,
               generator: Optional[torch.Generator] = None):
        count = state.count + 1
        bc = ref.bias_correction(beta, count)
        new_p: Dict = {}
        new_v: Dict = {}
        for path, p in leaves(params):
            g = tree_get(grads, path).to(torch.float32)
            v = (1.0 - beta) * g * g + beta * tree_get(state.g2, path)
            gstar = g * torch.rsqrt(v / bc + eps)
            w = p.to(torch.float32) * torch.exp(-lr * torch.sign(p) * gstar)
            tree_set(new_p, path, torch.clamp(w, -clip, clip).to(p.dtype))
            tree_set(new_v, path, v)
        return new_p, MadamState(g2=new_v, count=count)

    return init, update
