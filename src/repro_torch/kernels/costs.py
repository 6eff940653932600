"""Each kernel's own cost: the operations it must do and the bytes it must
move, from its arguments' shapes.

One function a kernel, :class:`Cost` out. ``chip_smoke.py``'s bound column
divides these by the card's rates (``launch.roofline``), and a dry run
adds them to a step's totals (``launch.cost``): the dispatch layer charges
a kernel's cost to an active sink on every device, and on the
``meta`` device, where the kernel does not run, it also keeps the cost in
a per-kernel tally (:func:`tally`).

Bytes count each input read once and each output written once; the
operations are what the function needs, not what the kernel issues (K8:
per product an add, a table load, a sign apply and an accumulate; K1 the
absmax, the log, the rounding and the pack). Where the work depends on
the data (K5's visible positions) the caller passes what the data needs;
on ``meta`` the dispatch layer passes the most it could need.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

__all__ = ["Cost", "K6_OPS", "K8_ALU_OPS_PER_PRODUCT",
           "K8_ALU_OPS_PER_WORD", "K8_ALU_OPS_PER_SLICE", "encode_pack",
           "qmatmul", "qmatmul_decode", "paged_attend", "fused_sample",
           "requant_pack", "madam_step", "madam_step_unpacked",
           "lns_matmul_packed", "active", "sink", "add", "charged", "tally",
           "reset_tally"]

# K6's operations an element: greedy a compare; noise-in a divide, an add
# and a compare; seeded also the noise (two mix32 rounds of 8 integer ops,
# 4 more to key, shift and convert, 2 to scale, two logs and two negations)
K6_OPS = {"greedy": 1, "noise-in": 3, "seeded": 3 + 16 + 4 + 2 + 4}
# K8's integer ops: a term's magnitude depends only on m = code_a + code_b,
# so a table of the 2 max_code + 1 terms leaves per product an add (m),
# one shared-memory load, a sign apply and an accumulate; each word is
# decoded once (code mask, sign bit); each output takes an add, a min and
# a max per block_k slice
K8_ALU_OPS_PER_PRODUCT = 3
K8_ALU_OPS_PER_WORD = 2
K8_ALU_OPS_PER_SLICE = 3
# Algorithm 1 a weight (K3, K4, K9): v's update, rsqrt, the step, the
# rounding, the clamp and the repack
_MADAM_OPS = 15


@dataclasses.dataclass(frozen=True)
class Cost:
    ops: float
    read: int
    written: int
    smem_loads: float = 0.0         # K8: one shared-memory load a product

    @property
    def bytes(self) -> int:
        return self.read + self.written


def encode_pack(R: int, C: int, x_bytes: int, word_bytes: int = 1,
                scale_numel: Optional[int] = None) -> Cost:
    """K1 on ``x (R, C)``: x read, the words and the ``(R, 1)`` f32 scale
    written; a given scale (``scale_numel`` elements) read and no absmax
    taken."""
    read = R * C * x_bytes + (0 if scale_numel is None else scale_numel * 4)
    ops = (8 if scale_numel is not None else 10) * R * C
    return Cost(ops, read, R * C * word_bytes + R * 4)


def qmatmul(M: int, K: int, N: int, out_bytes: int, *,
            word_bytes: int = 1, scales: bool = True) -> Cost:
    """K2, ``pa (M, K) @ pb (K, N)``: the words and the row and column
    scales read, the output written; ``2 M N K`` operations."""
    read = (M * K + K * N) * word_bytes + (4 * (M + N) if scales else 0)
    return Cost(2 * M * N * K, read, out_bytes * M * N)


def qmatmul_decode(M: int, K: int, N: int, padded_a: int, padded_b: int,
                   word_bytes: int = 1) -> Cost:
    """K2's decode pass: each word read once, each padded bf16 element
    (``padded_a + padded_b`` of them) written once; a table lookup and a
    sign apply an element."""
    return Cost(2 * (M * K + K * N), (M * K + K * N) * word_bytes,
                2 * (padded_a + padded_b))


def paged_attend(B: int, S: int, H: int, HD: int, KV: int, page: int,
                 max_pages: int, lengths: Sequence[int], *, q_bytes: int,
                 pool_bytes: int, packed: bool) -> Cost:
    """K5: q read and the f32 context written; of the pools, the pages
    each row's length reaches (and their bf16 scales when packed), the
    block table and the lengths; ``4 H HD`` operations a visible
    (query, key) pair (QK^T and PV)."""
    n_pos = sum(min(-(-int(n) // page), max_pages) * page for n in lengths)
    q_numel = B * S * H * HD
    read = (q_numel * q_bytes + n_pos * 2 * KV * HD * pool_bytes
            + (n_pos * 2 * KV * 2 if packed else 0) + B * max_pages * 4
            + B * 4)
    visible = sum(max(int(n) - S + s + 1, 0) for n in lengths
                  for s in range(S))
    return Cost(4 * H * HD * visible, read, q_numel * 4)


def fused_sample(B: int, V: int, case: str, logit_bytes: int = 4) -> Cost:
    """K6 over ``(B, V)`` logits: ``case`` ``"greedy"``, ``"noise-in"``
    (the gumbel noise read too, and the temperatures) or ``"seeded"`` (the
    noise drawn in the kernel); int32 tokens written."""
    reads = 2 if case == "noise-in" else 1
    read = B * V * logit_bytes * reads + (B * 4 if case != "seeded" else 0)
    return Cost(B * V * K6_OPS[case], read, B * 4)


def requant_pack(n: int, src_bytes: int = 1, dst_bytes: int = 1) -> Cost:
    """K7 over ``n`` words: each read and written once, five integer ops
    a word (unpack, shift, round, clamp, pack)."""
    return Cost(5 * n, n * src_bytes, n * dst_bytes)


def madam_step(n: int, word_bytes: int, g_bytes: int) -> Cost:
    """K3 (and K4) over ``n`` weights: words, gradients and f32 second
    moments read, words and moments written."""
    return Cost(_MADAM_OPS * n, n * (word_bytes + g_bytes + 4),
                n * (word_bytes + 4))


def madam_step_unpacked(n: int, code_bytes: int, g_bytes: int) -> Cost:
    """K9 over ``n`` weights kept as ``(code, sign)``: codes, one-byte
    signs, gradients and moments read, codes and moments written."""
    return Cost(_MADAM_OPS * n, n * (code_bytes + 1 + g_bytes + 4),
                n * (code_bytes + 4))


def lns_matmul_packed(M: int, K: int, N: int, block_k: int = 16,
                      word_bytes: int = 1) -> Cost:
    """K8, ``pa (M, K) @ pb (K, N)`` -> int32: the integer ops of the
    Fig.-6 datapath and one table load a product."""
    products = M * K * N
    slices = -(-K // block_k)
    alu = (K8_ALU_OPS_PER_PRODUCT * products
           + K8_ALU_OPS_PER_WORD * (M * K + K * N)
           + K8_ALU_OPS_PER_SLICE * M * N * slices)
    return Cost(alu, (M * K + K * N) * word_bytes, 4 * M * N,
                smem_loads=products)


# the active sinks: objects with ``charge(name, cost)``, an ``inside``
# depth of kernel calls in progress (the cost mode counts no aten op of a
# kernel's own: its plain version on the CPU, its wrapper's allocations on
# the card, so every device gives a call the same cost) and
# ``kernel_outputs(out)`` (a call's outputs, new storage)
_SINKS: list = []
_TALLY: Dict[str, List[float]] = {}


def active():
    return _SINKS[-1] if _SINKS else None


@contextlib.contextmanager
def sink(s):
    """Charge kernel calls to ``s`` within the block."""
    _SINKS.append(s)
    try:
        yield s
    finally:
        _SINKS.remove(s)


def add(table: Dict[str, list], name: str, cost: Cost) -> None:
    """One call of kernel ``name`` into ``table``: ``[calls, ops, read,
    written]`` by kernel."""
    row = table.setdefault(name, [0, 0.0, 0, 0])
    row[0] += 1
    row[1] += cost.ops
    row[2] += cost.read
    row[3] += cost.written


def charged(name: str, meta: bool, cost_fn, impl):
    """``impl`` wrapped to charge ``cost_fn()`` to the active sink (its
    own aten ops hidden from it) and, on ``meta``, to :func:`tally`."""
    def run(*args, **kwargs):
        s = active()
        cost = cost_fn()
        if meta:
            add(_TALLY, name, cost)
        if s is None:
            return impl(*args, **kwargs)
        s.charge(name, cost)
        s.inside += 1
        try:
            out = impl(*args, **kwargs)
        finally:
            s.inside -= 1
        s.kernel_outputs(out)
        return out
    return run


def tally() -> Dict[str, Dict[str, float]]:
    """The costs of the ``meta`` calls since :func:`reset_tally`, by
    kernel: ``calls``, ``ops``, ``read``, ``written``."""
    return {k: dict(zip(("calls", "ops", "read", "written"), v))
            for k, v in _TALLY.items()}


def reset_tally() -> None:
    _TALLY.clear()
