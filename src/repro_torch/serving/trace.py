"""Synthetic request traces (a copy of ``repro.serving.trace``: the same
seed gives the same trace in both packages). A codebook model's prompts
are ``(p, num_codebooks)`` id rows.

One generator, three length distributions:

  fixed   — every request is exactly (prompt_len, gen_len)
  uniform — mild jitter around the nominal lengths (CLI ``--mixed``)
  bimodal — chat-style short turns mixed with a long-generation tail,
            the regime where lock-step batching stalls whole groups

``rate`` > 0 spreads arrivals as a Poisson process (requests/second);
otherwise everything arrives at t=0.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serving.request import Request

__all__ = ["synthetic_trace", "max_trace_len"]


def synthetic_trace(cfg, *, requests: int, prompt_len: int, gen_len: int,
                    lengths: str = "fixed", rate: float = 0.0,
                    seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for i in range(requests):
        if lengths == "fixed":
            p, g = prompt_len, gen_len
        elif lengths == "uniform":
            p = max(1, int(round(prompt_len * rng.uniform(0.5, 1.5))))
            g = max(1, int(round(gen_len * rng.uniform(0.5, 1.5))))
        elif lengths == "bimodal":
            p = max(1, int(round(prompt_len * rng.uniform(0.5, 1.5))))
            if rng.uniform() < 0.25:  # long tail
                g = max(1, int(round(3.0 * gen_len * rng.uniform(0.8, 1.2))))
            else:
                g = max(1, int(round(0.5 * gen_len * rng.uniform(0.5, 1.5))))
        else:
            raise ValueError(f"unknown length distribution {lengths!r}")
        if rate > 0:
            t += rng.exponential(1.0 / rate)
        shape = (p, cfg.num_codebooks) if cfg.num_codebooks else (p,)
        prompt = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
        out.append(Request(rid=i, prompt=prompt, max_new_tokens=g, arrival=t))
    return out


def max_trace_len(prompt_len: int, gen_len: int, lengths: str = "fixed") -> int:
    """Cache capacity covering any request the distribution can draw."""
    if lengths == "bimodal":
        return int(1.5 * prompt_len + 3.6 * gen_len) + 2
    if lengths == "uniform":
        return int(1.5 * prompt_len + 1.5 * gen_len) + 2
    return prompt_len + gen_len + 2
