"""Render dry-run JSONL rows as the roofline table (the JAX package's
columns, dedup and order), the note against an H100's 80 GB; given two
files (single-pod and multi-pod), one table of both, a cell a row, with
each cell's trace seconds.

  PYTHONPATH=src python -m repro_torch.launch.report dryrun/singlepod.jsonl
  PYTHONPATH=src python -m repro_torch.launch.report single.jsonl multi.jsonl
"""
from __future__ import annotations

import json
import sys

from repro_torch.launch.roofline import HBM_BYTES

__all__ = ["fmt_bytes", "load", "table", "pair_table", "ORDER", "main"]

ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 2**30:.1f}"


def load(path):
    """The rows of a JSONL file, the last one of each (arch, shape,
    mesh)."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    dedup = {}
    for r in rows:
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return list(dedup.values())


def table(rows):
    out = ["| arch | shape | T_comp (s) | T_mem (s) | T_coll (s) | "
           "dominant | useful | roofline | peak GiB/chip | note |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        mem = r.get("memory", {}).get("peak_bytes")
        note = "exceeds H100 80 GB" if mem and mem > HBM_BYTES else ""
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_fraction']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {fmt_bytes(mem)} | {note} |")
    return "\n".join(out)


def pair_table(a, b):
    """Two runs' rows side by side (``a`` left), a cell a row: for each,
    the peak GiB a rank, T_comp / T_mem / T_coll (s; T_coll's network
    share in brackets where there is one) and the trace seconds; "-"
    where a run has no row for the cell (its log printed why)."""
    by = [{(r["arch"], r["shape"]): r for r in rows} for rows in (a, b)]
    keys = sorted(set(by[0]) | set(by[1]),
                  key=lambda k: (k[0], ORDER.get(k[1], 9)))

    def cell(r):
        if r is None:
            return "- | - | -"
        net = r.get("t_collective_network_s", 0.0)
        coll = f"{r['t_collective_s']:.3g}" + (f" ({net:.3g})" if net
                                               else "")
        return (f"{fmt_bytes(r['memory'].get('peak_bytes'))} | "
                f"{r['t_compute_s']:.3g} / {r['t_memory_s']:.3g} / {coll} "
                f"| {r['trace_s']:.1f}")
    out = ["| arch | shape | peak GiB | T_c / T_m / T_coll (s) | s | "
           "peak GiB | T_c / T_m / T_coll (s) | s |",
           "|---|---|---|---|---|---|---|---|"]
    for k in keys:
        out.append(f"| {k[0]} | {k[1]} | {cell(by[0].get(k))} | "
                   f"{cell(by[1].get(k))} |")
    return "\n".join(out)


def main(argv=None):
    paths = argv or sys.argv[1:]
    if len(paths) == 2:
        print(pair_table(load(paths[0]), load(paths[1])))
        return
    rows = load(paths[0])
    rows.sort(key=lambda r: (r["arch"], ORDER.get(r["shape"], 9)))
    print(table(rows))
    print(f"\n{len(rows)} cells.")


if __name__ == "__main__":
    main()
