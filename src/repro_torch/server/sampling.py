"""Per-request sampling parameters and the batch sampler.

Each decode slot carries its own temperature / top-k / top-p / seed and a
sample-event counter ``step`` (the prefill sample is step 0), held
host-side as ``(B,)`` numpy rows. ``sample_logits`` turns a ``(B, V)``
logits batch into token ids:

* an all-greedy batch is one K6 launch (``dispatch.fused_sample``);
* a batch with a sampled row is one seeded K6 launch
  (``dispatch.fused_sample_seeded``), which draws each row's gumbel noise
  from (seed, step, token id) itself; the rows' parameters travel in the
  launch, so no noise tensor and no per-row torch op exist;
* a batch with an active top-k/top-p row also takes a plain torch sort
  path for its sampled rows, with the noise K6 wrote (``noise_out``).

The noise is a counter-based hash of (seed, step, token id)
(``kernels.ref.gumbel_noise``), so a seeded request replays token for
token within the port, whichever rows share its batch, and the CPU and
the card draw the same noise up to the last bit of ``log``. It is not the
JAX package's ``jax.random`` stream: the two frameworks draw different
numbers.

Codebook stacks (``num_codebooks`` = K, musicgen): the ``(B, K * V)``
logits are sampled as ``B * K`` rows of width V in one call (row
``b * K + k`` is codebook k of slot b), each with its slot's parameters
and step; a seeded row's codebook k draws with the seed
:func:`codebook_seed` folds in, so the K codebooks of one sample event
draw different noise and still replay. Tokens come back ``(B, K)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional

import numpy as np
import torch

from repro_torch.kernels import dispatch, ops

__all__ = ["SamplingParams", "GREEDY", "sampling_rows", "set_row",
           "sample_logits", "codebook_seed"]

# the golden-ratio constant codebook k's seed is xor-ed with k times
_CODEBOOK_MIX = 0x9E3779B9


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

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


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


def _cat(ts):
    """One tensor as it is (no copy kernel), several concatenated."""
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def codebook_seed(seed, k):
    """The seed codebook ``k`` of a seeded row draws with:
    ``seed ^ (k * 0x9E3779B9 mod 2**32)``, as uint32. Codebook 0 keeps the
    row's seed; distinct codebooks of one seed get distinct seeds, so
    their noise differs (K6's noise is a hash of (seed, step, token id),
    and ``mix32`` of the seed is a bijection)."""
    mix = (np.asarray(k, np.uint64) * _CODEBOOK_MIX) & 0xFFFFFFFF
    return np.asarray(seed, np.uint32) ^ mix.astype(np.uint32)


def sample_logits(logits: torch.Tensor, rows: Dict[str, np.ndarray], *,
                  num_codebooks: int = 0, vocab_size: Optional[int] = None,
                  step_offset=None) -> torch.Tensor:
    """``logits (B, V)`` + per-slot rows -> token ids ``(B,)`` int32; with
    ``num_codebooks`` = K, ``logits (B, K * vocab_size)`` -> ``(B, K)``
    (module docstring).

    ``step_offset`` (an int or a ``(B,)`` array) shifts each row's sample
    counter without mutating ``rows``: the speculative verify samples its
    position ``j`` with ``step + j``, the noise the baseline engine draws
    for that token."""
    if num_codebooks:
        B, K = logits.shape[0], num_codebooks
        flat = {n: np.repeat(v, K) for n, v in rows.items()}
        flat["seed"] = codebook_seed(flat["seed"], np.tile(np.arange(K), B))
        if step_offset is not None:
            step_offset = np.repeat(np.broadcast_to(step_offset, (B,)), K)
        return _sample(logits.reshape(B * K, vocab_size), flat,
                       step_offset).reshape(B, K)
    return _sample(logits, rows, step_offset)


def _sample(logits: torch.Tensor, rows: Dict[str, np.ndarray],
            step_offset) -> torch.Tensor:
    """:func:`sample_logits` over flat rows ``(N, V)``."""
    lg = logits.to(torch.float32).contiguous()
    temp = rows["temp"]
    if not np.any(temp > 0.0):
        return dispatch.fused_sample(lg, None, None)
    step = rows["step"].astype(np.int64)
    if step_offset is not None:
        step = step + step_offset
    step = step.astype(np.int32)
    masked = (rows["top_k"] > 0) | (rows["top_p"] < 1.0)
    draw = bool(np.any(masked & (temp > 0.0)))
    n = ops.K6_MAX_ROWS                    # rows a seeded launch takes
    parts = [dispatch.fused_sample_seeded(
        lg[i:i + n], temp[i:i + n], rows["seed"][i:i + n], step[i:i + n],
        noise_out=draw) for i in range(0, lg.shape[0], n)]
    if not draw:
        return _cat(parts)
    out, gumbel = (_cat(list(x)) for x in zip(*parts))
    temp_t = torch.as_tensor(temp, dtype=torch.float32, device=lg.device)
    scaled = lg / torch.clamp_min(temp_t, 1e-6)[:, None]
    for b in np.flatnonzero(temp > 0.0):
        out[b] = _mask_sample(scaled[b], int(rows["top_k"][b]),
                              float(rows["top_p"][b]), gumbel[b])
    return out
