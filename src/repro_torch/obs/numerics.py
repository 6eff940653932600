"""Per-layer LNS numerics health, the counterpart of
``repro.obs.numerics``.

In the train step: stable layer names for a parameter path, the
encode-site rail-saturation stats of the gradient quantizer Q_G, and the
serving tree's code-rail occupancy (``tree_code_stats``, read by
``Engine.numerics_snapshot``). The update-site stats come from the Madam
kernel's epilogue (K4, ``kernels/madam_stats.py``).

On the host: :class:`NumericsObserver` takes each step's metrics (one
transfer to the host a step for every scalar in them) and renders a
jsonl step log, Prometheus text through ``obs.prom.render_prometheus``
(a ``{layer=...}`` gauge family a stat), Chrome trace counter tracks
beside ``train_step`` spans, and the summary the train CLI prints.
:func:`validate_train_trace` is the contract of the exported trace.
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.lns import LNSFormat, compute_scale, is_lns_weight
from repro_torch.obs.prom import render_prometheus
from repro_torch.obs.spans import _check_event
from repro_torch.tree import leaves

__all__ = ["NumericsObserver", "path_name", "encode_sat_stats",
           "grad_encode_stats", "tree_code_stats", "validate_train_trace",
           "REQUIRED_TRAIN_COUNTERS"]

# counter tracks (site/stat) an exported training trace must carry; the
# per-layer series live in each counter event's args
REQUIRED_TRAIN_COUNTERS = ("update/sat_hi", "update/sat_lo",
                           "update/qerr_rel", "update/dead_frac")

_TINY = torch.finfo(torch.float32).tiny


def path_name(path: Tuple[str, ...]) -> str:
    """A parameter path as the dotted layer name the JAX package uses
    (``period.pos0.attn.wq``)."""
    return ".".join(str(p) for p in path) or "root"


def encode_sat_stats(x: torch.Tensor, fmt: LNSFormat, scale_axis=None,
                     scale=None) -> Dict[str, torch.Tensor]:
    """Rail-saturation fractions of encoding ``x`` into ``fmt``: the
    pre-clip rounded exponent, re-derived as ``lns_encode`` computes it,
    below code 0 (``sat_lo``) or above ``max_code`` (``sat_hi``), and the
    mean log2 of the pow2 scale (0-d f32 tensors). ``scale`` is the
    encode's scale where it is not ``x``'s own (a shard's whole-leaf
    scale)."""
    if scale is None:
        scale = compute_scale(x, axis=scale_axis)
    mag = x.to(torch.float32).abs() / scale
    e = -torch.log2(torch.clamp_min(mag, _TINY)) * fmt.gamma
    rounded = torch.floor(e + 0.5)
    inv = 1.0 / float(max(x.numel(), 1))
    return {
        "sat_lo": (rounded < 0).to(torch.float32).sum() * inv,
        "sat_hi": (rounded > fmt.max_code).to(torch.float32).sum() * inv,
        "scale_log2": torch.log2(scale).mean(),
    }


def grad_encode_stats(grads, qcfg,
                      groups=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Encode-site stats of Q_G for every >=2-D gradient leaf, keyed by
    layer name; ``{}`` when the config quantizes no gradients. ``groups``
    (``core.quantizer.quantize_grads``' tree) gives a shard its whole
    leaf's scale, as Q_G encodes it; its fractions stay the shard's."""
    from repro_torch.core.quantizer import global_stat
    fmt = getattr(qcfg, "grad", None)
    if not isinstance(fmt, LNSFormat):
        return {}
    axis = getattr(qcfg, "grad_scale_axis", None)
    gr = dict(leaves(groups)) if groups is not None else {}
    return {path_name(p): encode_sat_stats(
                g, fmt, axis, global_stat(g, fmt, axis, gr.get(p)))
            for p, g in leaves(grads) if g.dim() >= 2}


def tree_code_stats(params, reduce=None) -> Dict[str, Any]:
    """Code-rail occupancy of every packed leaf: the share of codes at 0
    (the largest magnitude) and at ``max_code`` (the flush-to-zero rail)
    and the mean code, over all ``elements``. Codes piling at a rail mean
    the serving copy lost resolution. One pass over the words on their
    device, a leaf's four integer sums back to the host in one copy
    (int64, so a full-width tree's code sum does not wrap). ``reduce``
    (a mesh engine's) takes a leaf's path and its sums and returns them
    summed over the ranks that hold its shards, so a rank's local tree
    gives the whole tree's occupancy."""
    tot = lo = hi = code_sum = 0
    for path, leaf in leaves(params):
        if not is_lns_weight(leaf):
            continue
        fmt = leaf.fmt
        code = leaf.packed.to(torch.int32) & fmt.max_code
        sums = torch.stack([(code == 0).sum(), (code == fmt.max_code).sum(),
                            code.sum(), torch.tensor(code.numel(),
                                                     device=code.device)])
        if reduce is not None:
            sums = reduce(path, sums)
        a, b, c, n = sums.tolist()
        lo, hi, code_sum, tot = lo + a, hi + b, code_sum + c, tot + n
    if tot == 0:
        return {"elements": 0}
    return {"elements": tot, "code0_frac": lo / tot,
            "maxcode_frac": hi / tot, "code_mean": code_sum / tot}


# ---------------------------------------------------------------------------
# the host-side observer


def _to_float_tree(tree) -> Any:
    """A nested dict of 0-d tensors (and plain numbers) as plain floats,
    in one transfer to the host: every tensor leaf is cast to f64 (exact
    for K4's f64 stat rows and for f32) and stacked, and the stack is
    read back with one ``.cpu().tolist()``, never an ``.item()`` a leaf
    (a full-width step carries hundreds of them). Dicts come back with
    their keys sorted, as a JAX pytree round trip returns them, so the
    rows, the worst-saturation pick and the Prometheus text follow the
    JAX package's order."""
    tensors: List[torch.Tensor] = []

    def collect(node):
        if isinstance(node, dict):
            for k in sorted(node):
                collect(node[k])
        elif isinstance(node, torch.Tensor):
            tensors.append(node.reshape(()).to(torch.float64))

    collect(tree)
    vals = iter(torch.stack(tensors).cpu().tolist() if tensors else ())

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, torch.Tensor):
            return next(vals)
        return float(node)

    return build(tree)


def _host_scalars(metrics: Dict[str, Any]) -> Tuple[Dict[str, float], Any]:
    """``loss``/``grad_norm`` and the ``numerics`` dict of one step's
    metrics as floats, through one :func:`_to_float_tree` transfer. A
    non-numeric ``loss``/``grad_norm`` is left out, as the JAX observer
    leaves it."""
    tree: Dict[str, Any] = {"numerics": metrics.get("numerics") or {}}
    scalars: Dict[str, Any] = {}
    for k in ("loss", "grad_norm"):
        v = metrics.get(k)
        if isinstance(v, torch.Tensor):
            if v.numel() == 1:
                scalars[k] = v
        elif v is not None:
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                pass
    tree["scalars"] = scalars
    host = _to_float_tree(tree)
    return host["scalars"], host["numerics"]


class NumericsObserver:
    """Collects each step's metrics; renders jsonl, Prometheus text,
    Chrome counter tracks and aggregate summaries.

    ``record_step`` is the only per-step call: one transfer of the step's
    scalars to the host (the loop already waited on the loss), one jsonl
    line when ``log_path`` is set, one progress line when ``quiet`` is
    off. Rows are kept in a bounded ring (``history``) for the export.
    """

    def __init__(self, *, log_path: Optional[str] = None,
                 history: int = 4096, quiet: bool = True,
                 progress_every: int = 10):
        self.log_path = log_path
        self.quiet = quiet
        self.progress_every = max(1, progress_every)
        self.started_at = time.time()
        self._t0 = time.perf_counter()
        self._rows: "deque[Dict[str, Any]]" = deque(maxlen=max(1, history))
        self._recorded = 0
        self._log_file = None
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                        exist_ok=True)
            self._log_file = open(log_path, "w")

    # -- the per-step sink ----------------------------------------------

    def record_step(self, step: int, metrics: Dict[str, Any],
                    walltime_s: Optional[float] = None) -> Dict[str, Any]:
        """Record one train step's metrics (with or without the
        ``numerics`` dict). Returns the recorded row."""
        row: Dict[str, Any] = {
            "step": int(step),
            "t": time.perf_counter() - self._t0,
        }
        if walltime_s is not None:
            row["dt_s"] = float(walltime_s)
        scalars, num = _host_scalars(metrics)
        for k in ("loss", "grad_norm"):
            if k in scalars:
                row[k] = scalars[k]
        row["numerics"] = num
        self._rows.append(row)
        self._recorded += 1
        if self._log_file is not None:
            self._log_file.write(json.dumps(row) + "\n")
            self._log_file.flush()
        if not self.quiet and (step % self.progress_every == 0 or step == 1):
            print(self._progress_line(row))
        return row

    def _progress_line(self, row: Dict[str, Any]) -> str:
        bits = [f"[train] step {row['step']}"]
        if "loss" in row:
            bits.append(f"loss {row['loss']:.4f}")
        if "dt_s" in row:
            bits.append(f"dt {row['dt_s'] * 1e3:.1f}ms")
        worst = self._worst_sat(row)
        if worst is not None:
            site, layer, frac = worst
            bits.append(f"sat {frac:.3f} ({site}:{layer})")
        return "  ".join(bits)

    @staticmethod
    def _worst_sat(row: Dict[str, Any]):
        worst = None
        for site, layers in (row.get("numerics") or {}).items():
            for layer, stats in layers.items():
                frac = stats.get("sat_lo", 0.0) + stats.get("sat_hi", 0.0)
                if worst is None or frac > worst[2]:
                    worst = (site, layer, frac)
        return worst

    @property
    def n_steps(self) -> int:
        return self._recorded

    def latest(self) -> Optional[Dict[str, Any]]:
        return self._rows[-1] if self._rows else None

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None

    # -- Prometheus ------------------------------------------------------

    def prom_stats(self):
        """``(flat_stats, labeled)`` for ``render_prometheus``: the flat
        aggregates (worst saturation, last loss, ...) and the per-layer
        gauge families ``numerics_<site>_<stat>``, a ``{layer=...}``
        label each."""
        row = self.latest()
        if row is None:
            return {"numerics_steps": 0}, {}
        stats: Dict[str, Any] = {
            "numerics_steps": self._recorded,
            "numerics_last_step": row["step"],
        }
        for k in ("loss", "grad_norm", "dt_s"):
            if k in row:
                stats[f"numerics_{k}"] = row[k]
        labeled: Dict[str, List] = {}
        for site, layers in (row.get("numerics") or {}).items():
            for layer, per in layers.items():
                for stat, v in per.items():
                    name = f"numerics_{site}_{stat}"
                    labeled.setdefault(name, []).append(
                        ({"layer": layer}, v))
        for name, samples in labeled.items():
            vals = [v for _, v in samples if not math.isnan(v)]
            if vals:
                stats[name + "_max"] = max(vals)
        return stats, labeled

    def prom_text(self, prefix: str = "repro_") -> str:
        stats, labeled = self.prom_stats()
        return render_prometheus(stats, info={"kind": "train"},
                                 prefix=prefix, labeled=labeled)

    # -- Chrome trace ----------------------------------------------------

    def to_chrome_counters(self, stride: int = 1) -> List[Dict[str, Any]]:
        """Counter tracks (``ph: "C"``): an event a recorded step and
        (site, stat), its per-layer series in ``args``."""
        events: List[Dict[str, Any]] = []
        for row in list(self._rows)[::max(1, stride)]:
            ts = row["t"] * 1e6
            per_track: Dict[str, Dict[str, float]] = {}
            for site, layers in (row.get("numerics") or {}).items():
                for layer, per in layers.items():
                    for stat, v in per.items():
                        if math.isnan(v):
                            continue
                        per_track.setdefault(f"{site}/{stat}", {})[layer] = \
                            round(v, 6)
            if "loss" in row:
                per_track["loss"] = {"loss": row["loss"]}
            for track, args in sorted(per_track.items()):
                events.append({"ph": "C", "name": f"numerics/{track}",
                               "cat": "numerics", "pid": 0, "tid": 0,
                               "ts": ts, "args": args})
        return events

    def to_chrome(self) -> Dict[str, Any]:
        """The whole document: step spans and the numerics counters."""
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "repro training"}},
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
             "args": {"name": "train"}},
        ]
        for row in self._rows:
            if "dt_s" not in row:
                continue
            dur = max(row["dt_s"], 0.0) * 1e6
            args = {"step": row["step"]}
            if "loss" in row:
                args["loss"] = row["loss"]
            events.append({"ph": "X", "name": "train_step", "cat": "train",
                           "pid": 0, "tid": 0,
                           "ts": max(row["t"] * 1e6 - dur, 0.0),
                           "dur": dur, "args": args})
        events.extend(self.to_chrome_counters())
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"steps_recorded": self._recorded}}

    def export(self, trace_dir: str, tag: str = "train") -> Dict[str, str]:
        """Write ``{tag}-{stamp}.trace.json`` and ``.summary.json``."""
        os.makedirs(trace_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        trace_path = os.path.join(trace_dir, f"{tag}-{stamp}.trace.json")
        with open(trace_path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
        summary_path = os.path.join(trace_dir, f"{tag}-{stamp}.summary.json")
        with open(summary_path, "w") as f:
            json.dump(self.summary(), f, indent=2)
            f.write("\n")
        return {"trace": trace_path, "summary": summary_path}

    # -- aggregates ------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Worst and mean health over the retained rows."""
        out: Dict[str, Any] = {"steps": self._recorded,
                               "retained": len(self._rows)}
        agg: Dict[str, List[float]] = {}
        for row in self._rows:
            for site, layers in (row.get("numerics") or {}).items():
                for per in layers.values():
                    for stat, v in per.items():
                        if not math.isnan(v):
                            agg.setdefault(f"{site}.{stat}", []).append(v)
        for key, vals in sorted(agg.items()):
            out[key + "_max"] = max(vals)
            out[key + "_mean"] = sum(vals) / len(vals)
        worst = self._worst_sat(self.latest() or {})
        if worst is not None:
            out["worst_sat_site"] = f"{worst[0]}:{worst[1]}"
            out["worst_sat_frac"] = worst[2]
        return out


# ---------------------------------------------------------------------------
# the training trace's contract


def validate_train_trace(doc: Dict[str, Any],
                         require: tuple = REQUIRED_TRAIN_COUNTERS
                         ) -> Dict[str, Any]:
    """Check an exported training trace: the span schema of every event,
    at least one ``train_step`` complete span, and a
    ``numerics/<site>/<stat>`` counter track (with at least one numeric
    layer series) for every required (site, stat). Returns counts;
    raises ``ValueError`` on any violation."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace document must hold a traceEvents list")
    steps = 0
    counters: Dict[str, int] = {}
    series: set = set()
    for i, ev in enumerate(doc["traceEvents"]):
        _check_event(ev, i)
        if ev["ph"] == "X" and ev["name"] == "train_step":
            steps += 1
        elif ev["ph"] == "C" and str(ev["name"]).startswith("numerics/"):
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                raise ValueError(
                    f"traceEvents[{i}] counter {ev['name']!r} has no series")
            for v in args.values():
                if not isinstance(v, (int, float)):
                    raise ValueError(
                        f"traceEvents[{i}] counter {ev['name']!r} holds a "
                        f"non-numeric series value")
            track = ev["name"][len("numerics/"):]
            counters[track] = counters.get(track, 0) + 1
            series.update(f"{track}:{k}" for k in args)
    if steps == 0:
        raise ValueError("trace holds no train_step span")
    missing = [t for t in require if not counters.get(t)]
    if missing:
        raise ValueError(f"trace lacks numerics counter track(s) {missing}; "
                         f"has {sorted(counters)}")
    return {"steps": steps, "counter_events": sum(counters.values()),
            "tracks": sorted(counters), "series": len(series)}
