"""Per-request sampling parameters and the batch sampler.

Each decode slot carries its own temperature / top-k / top-p / seed and a
sample-event counter ``step`` (the prefill sample is step 0), held
host-side as ``(B,)`` numpy rows. ``sample_logits`` turns a ``(B, V)``
logits batch into token ids:

* an all-greedy batch is one K6 launch (``dispatch.fused_sample``);
* a temperature-only batch adds gumbel noise and is one K6 launch too;
* a batch with an active top-k/top-p row takes a plain torch sort path.

The gumbel noise of a row comes from a ``torch.Generator`` on the logits'
device seeded from (seed, step), so a seeded request replays
token for token within the port. It does not replay the JAX package's
``jax.random`` stream: the two frameworks draw different numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional

import numpy as np
import torch

from repro_torch.kernels import dispatch

__all__ = ["SamplingParams", "GREEDY", "sampling_rows", "set_row",
           "sample_logits", "row_gumbel"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature 0 is greedy; top_k 0 and top_p 1.0 are disabled."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop: FrozenSet[int] = frozenset()

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not isinstance(self.stop, frozenset):
            object.__setattr__(self, "stop",
                               frozenset(int(t) for t in self.stop))
        object.__setattr__(self, "seed", int(self.seed) & 0xFFFFFFFF)


GREEDY = SamplingParams()

ROW_DTYPES = {"temp": np.float32, "top_k": np.int32, "top_p": np.float32,
              "seed": np.uint32, "step": np.int32}


def sampling_rows(batch: int) -> Dict[str, np.ndarray]:
    """Host-side per-slot sampling state, all greedy."""
    rows = {k: np.zeros((batch,), dt) for k, dt in ROW_DTYPES.items()}
    rows["top_p"][:] = 1.0
    return rows


def set_row(rows: Dict[str, np.ndarray], slot: int,
            sp: Optional[SamplingParams]) -> None:
    """Bind slot ``slot`` to ``sp`` (None: greedy), step reset to 0."""
    sp = sp or GREEDY
    rows["temp"][slot] = sp.temperature
    rows["top_k"][slot] = sp.top_k
    rows["top_p"][slot] = sp.top_p
    rows["seed"][slot] = sp.seed
    rows["step"][slot] = 0


def _mix64(x: int) -> int:
    """splitmix64 finalizer: spreads (seed, step) over all 64 bits, since
    the CPU generator keeps only the low 32 bits of its seed."""
    m = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


def row_gumbel(seed: int, step: int, vocab: int,
               device: torch.device) -> torch.Tensor:
    """Gumbel noise ``(V,)`` for one sample event of one request."""
    gen = torch.Generator(device=device).manual_seed(
        _mix64((int(seed) << 32) | (int(step) & 0xFFFFFFFF)))
    u = torch.rand((vocab,), generator=gen, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _mask_sample(scaled: torch.Tensor, top_k: int, top_p: float,
                 gumbel: torch.Tensor) -> torch.Tensor:
    """Top-k / top-p masked gumbel-argmax of one row ``(V,)``; the noise
    is indexed by token id, so an unmasked row draws what the sort-free
    path would."""
    v = scaled.shape[-1]
    order = torch.argsort(-scaled, stable=True)
    ranked = scaled[order]
    k_eff = v if top_k <= 0 else min(top_k, v)
    ranked = torch.where(torch.arange(v, device=scaled.device) < k_eff,
                         ranked, float("-inf"))
    probs = torch.softmax(ranked, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    ranked = torch.where(keep, ranked, float("-inf"))
    return order[torch.argmax(ranked + gumbel[order])].to(torch.int32)


def sample_logits(logits: torch.Tensor,
                  rows: Dict[str, np.ndarray]) -> torch.Tensor:
    """``logits (B, V)`` + per-slot rows -> token ids ``(B,)`` int32."""
    lg = logits.to(torch.float32).contiguous()
    temp = rows["temp"]
    if not np.any(temp > 0.0):
        return dispatch.fused_sample(lg, None, None)
    B, V = lg.shape
    gumbel = torch.zeros_like(lg)
    for b in np.flatnonzero(temp > 0.0):
        gumbel[b] = row_gumbel(rows["seed"][b], rows["step"][b], V, lg.device)
    temp_t = torch.as_tensor(temp, dtype=torch.float32, device=lg.device)
    masked = (rows["top_k"] > 0) | (rows["top_p"] < 1.0)
    if not np.any(masked):
        return dispatch.fused_sample(lg, gumbel, temp_t)
    out = dispatch.fused_sample(lg, None, None)
    scaled = lg / torch.clamp_min(temp_t, 1e-6)[:, None]
    for b in np.flatnonzero(temp > 0.0):
        out[b] = _mask_sample(scaled[b], int(rows["top_k"][b]),
                              float(rows["top_p"][b]), gumbel[b])
    return out
