"""Self-speculative decoding support: draft views, support gating,
autotuner (the PyTorch counterpart of ``repro.serving.spec``).

The draft model costs no second checkpoint in LNS-Madam: a bitwidth is a
re-grid of the packed wire word (``lns_requant_packed``; on the card one
K7 launch re-grids every leaf of a view), so a B=6/7 draft is the same
8-bit weights on a coarser exponent grid with the scale tensors shared
(paper §6.1.1). The engine builds a view
per draft bitwidth on first use (:func:`build_draft_params`), runs k
greedy draft steps per slot, then scores all k tokens with the serving
weights in one S=k verify pass (``serving/engine.py``).

This module is engine-agnostic: the parameter transform, the "can this
architecture rewind?" predicate, and the accept-rate feedback autotuner
over (draft bitwidth, k) arms.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.lns import (LNSFormat, LNSWeight, is_lns_weight,
                                  lns_decode_packed)
from repro_torch.kernels import dispatch, ops
from repro_torch.tree import leaves, tree_set

__all__ = ["SpecConfig", "spec_supported", "build_draft_params",
           "draft_requant_error", "request_class", "SpecAutotuner"]

Arm = Tuple[int, int]  # (draft_bits, k)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Engine-level speculative decoding settings.

    k:            draft tokens per cycle (>= 1); the verify pass scores all
                  k in one S=k forward.
    draft_bits:   wire bitwidth of the draft view (8 = the serving weights
                  themselves: every draft accepts).
    autotune:     explore (bits, k) arms from accept-rate/throughput
                  feedback instead of pinning the configured pair.
    bits_choices/k_choices: the autotuner's arm grid (the configured
                  (draft_bits, k) is always included).
    decide_every: cycles between autotuner arm decisions.
    min_visits:   decisions each arm gets before exploitation starts.
    ema:          smoothing factor for reward / accept-rate EMAs.
    """

    k: int = 4
    draft_bits: int = 6
    autotune: bool = False
    bits_choices: Tuple[int, ...] = (6, 7, 8)
    k_choices: Tuple[int, ...] = (2, 4, 8)
    decide_every: int = 8
    min_visits: int = 1
    ema: float = 0.25

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculate k must be >= 1, got {self.k}")
        if not 2 <= self.draft_bits <= 8:
            raise ValueError(
                f"draft_bits must be in [2, 8], got {self.draft_bits}")

    def arms(self) -> List[Arm]:
        """The autotuner grid (configured arm first, then the rest)."""
        base = (self.draft_bits, self.k)
        grid = [base]
        for b, k in itertools.product(self.bits_choices, self.k_choices):
            if (b, k) != base:
                grid.append((b, k))
        return grid


def spec_supported(cfg) -> Optional[str]:
    """None when speculative decoding is sound for ``cfg``, else the
    reason. Rewind resets per-slot KV cursors, which position-addressed
    attention caches allow; recurrent layers fold state irreversibly and
    multi-codebook heads emit token tuples the accept rule does not
    model."""
    prefix, _, period = cfg.layer_pattern()
    kinds = set(prefix) | set(period)
    if kinds & {"mamba", "rwkv"}:
        return "recurrent layers cannot rewind rejected draft state"
    if getattr(cfg, "num_codebooks", 0):
        return "multi-codebook sampling is not modelled by the accept rule"
    return None


def build_draft_params(params, bits: int):
    """Re-grid every ``LNSWeight`` leaf of ``params`` to ``bits`` wire bits.
    The leaves are grouped by ``(src, dst)`` format and each group goes
    through one ``dispatch.requant_pack_many`` call (one K7 launch on CUDA
    tensors; a group of more than ``ops.K7_MAX_LEAVES`` leaves takes one
    call per that many), so smollm-135m's view is one launch.

    Scale tensors and every non-LNS leaf are shared by reference, so the
    view costs one uint8 tree. When no leaf changes (``bits`` is the
    serving width) the result is ``params`` itself: the identity arm.
    """
    groups: Dict[Tuple[LNSFormat, LNSFormat], List] = {}
    for path, leaf in leaves(params):
        if is_lns_weight(leaf) and leaf.fmt.with_bits(bits) != leaf.fmt:
            groups.setdefault((leaf.fmt, leaf.fmt.with_bits(bits)),
                              []).append((path, leaf))
    if not groups:
        return params
    new = {}
    for (src, dst), members in groups.items():
        for i in range(0, len(members), ops.K7_MAX_LEAVES):
            part = members[i:i + ops.K7_MAX_LEAVES]
            words = dispatch.requant_pack_many([w.packed for _, w in part],
                                               src, dst)
            for (path, leaf), packed in zip(part, words):
                new[path] = LNSWeight(packed, leaf.scale, dst)
    view: Dict = {}
    for path, leaf in leaves(params):
        tree_set(view, path, new.get(path, leaf))
    return view


def draft_requant_error(params, draft_params,
                        reduce=None) -> Dict[str, float]:
    """Numerics health of a draft view against its target tree:
    ``rel_err_mean``, mean |decode(draft) - decode(target)| over mean
    |decode(target)|, and ``sat_hi_frac``, the fraction of target codes
    the down-grid clamps at the coarse grid's rail. ``reduce`` as in
    ``obs.numerics.tree_code_stats``: a leaf's path and its f64 sums
    (error, reference, saturated, elements) summed over its ranks."""
    src = [(p, x) for p, x in leaves(params) if is_lns_weight(x)]
    dst = [x for _, x in leaves(draft_params) if is_lns_weight(x)]
    err = ref = sat = 0.0
    n = 0
    bits = None
    f64 = torch.float64
    for (path, s), d in zip(src, dst):
        bits = d.fmt.bits
        zero = torch.zeros((), dtype=f64, device=s.packed.device)
        e = r = z = zero
        if d is not s:  # an identity leaf has zero error
            sv = lns_decode_packed(s.packed, s.fmt, torch.float32)
            dv = lns_decode_packed(d.packed, d.fmt, torch.float32)
            e = torch.sum(torch.abs(dv - sv)).to(f64)
            r = torch.sum(torch.abs(sv)).to(f64)
            ratio = s.fmt.gamma // d.fmt.gamma
            if ratio >= 1:
                code = s.packed.to(torch.int32) & s.fmt.max_code
                z = torch.sum(torch.div(code + ratio // 2, ratio,
                                        rounding_mode="floor")
                              > d.fmt.max_code).to(f64)
        sums = torch.stack([e, r, z, zero + s.packed.numel()])
        if reduce is not None:
            sums = reduce(path, sums)
        a, b, c, m = sums.tolist()
        err, ref, sat, n = err + a, ref + b, sat + c, n + int(m)
    if n == 0:
        return {"elements": 0}
    return {"bits": bits, "elements": n,
            "rel_err_mean": err / ref if ref > 0 else 0.0,
            "sat_hi_frac": sat / n}


def request_class(request) -> str:
    """Autotuner request class: greedy requests accept far more drafts
    than sampled ones, so accept-rate feedback is tracked per class."""
    sp = request.sampling
    return "greedy" if sp is None or sp.is_greedy else "sampled"


class SpecAutotuner:
    """Deterministic bandit over (draft_bits, k) arms.

    Reward is measured emitted tokens per second per cycle (EMA per arm).
    Exploration uses no RNG, so a replayed feed tunes identically: arms
    are first visited round-robin ``min_visits`` times, then every fourth
    decision re-measures the least-visited arm while the rest exploit the
    best EMA. Per-(bits, class) accept-rate EMAs ride along for
    :meth:`snapshot`.
    """

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self.arms: List[Arm] = cfg.arms()
        self.current: Arm = (cfg.draft_bits, cfg.k)
        self.reward: Dict[Arm, float] = {}
        self.visits: Dict[Arm, int] = {a: 0 for a in self.arms}
        self.accept: Dict[Tuple[int, str], float] = {}
        self.cycles = 0
        self.decisions = 0

    def observe(self, arm: Arm, emitted: int, wall_s: float,
                class_accepts: Dict[str, Tuple[int, int]]) -> None:
        """Record one cycle run under ``arm``: ``emitted`` tokens in
        ``wall_s`` seconds, plus per-class (accepted, drafted) counts."""
        self.cycles += 1
        self.visits[arm] = self.visits.get(arm, 0) + 1
        ema = self.cfg.ema
        if wall_s > 0:
            r = emitted / wall_s
            prev = self.reward.get(arm)
            self.reward[arm] = r if prev is None else (1 - ema) * prev + ema * r
        for cls, (acc, drafted) in class_accepts.items():
            if drafted <= 0:
                continue
            key = (arm[0], cls)
            rate = acc / drafted
            prev = self.accept.get(key)
            self.accept[key] = (rate if prev is None
                                else (1 - ema) * prev + ema * rate)

    def propose(self) -> Arm:
        """The arm for the next cycle (changes every ``decide_every``)."""
        if self.cycles % self.cfg.decide_every:
            return self.current
        self.decisions += 1
        cold = [a for a in self.arms if self.visits[a] < self.cfg.min_visits]
        if cold:
            self.current = cold[0]
        elif self.decisions % 4 == 0:
            self.current = min(self.arms, key=lambda a: self.visits[a])
        else:
            self.current = max(
                self.arms, key=lambda a: self.reward.get(a, 0.0))
        return self.current

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-safe dict of the tuner's state."""
        out: Dict[str, object] = {
            "spec_arm_bits": self.current[0],
            "spec_arm_k": self.current[1],
            "spec_tuner_cycles": self.cycles,
        }
        for (bits, cls), rate in sorted(self.accept.items()):
            out[f"spec_accept_rate_b{bits}_{cls}"] = round(rate, 4)
        for (bits, k), r in sorted(self.reward.items()):
            out[f"spec_reward_b{bits}_k{k}"] = round(r, 2)
        return out
