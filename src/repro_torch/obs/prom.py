"""Prometheus text exposition (format 0.0.4) for the gateway: a copy of
``repro.obs.prom`` (the port imports nothing of the JAX package). It
needs no torch and renders the same bytes.

Two halves:

* :class:`Histogram` — a tiny fixed-bucket cumulative histogram the
  driver feeds as requests finish (TTFT / TPOT / queue-wait). Updates
  are O(#buckets) integer bumps, cheap enough to stay always-on.
* :func:`render_prometheus` — flattens the driver's existing JSON stats
  snapshot plus histogram state into the standard text format, so a
  stock Prometheus server can scrape ``GET /metrics`` with no adapter.

:func:`parse_prometheus_text` is the inverse the tests use: a strict-enough
parser that asserts ``# TYPE`` lines precede their samples, every sample
value parses as a float, and each histogram carries a ``+Inf`` bucket
with consistent ``_sum``/``_count`` series.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Histogram", "render_prometheus", "parse_prometheus_text",
           "LATENCY_BUCKETS"]

# seconds; spans sub-ms sampler ticks through multi-second TTFT tails
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Cumulative-bucket histogram in the Prometheus model."""

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float] = LATENCY_BUCKETS):
        self.name = name
        self.help = help_text
        self.bounds = tuple(sorted(buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if v is None or math.isnan(v):
            return
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                self._counts[i] += 1
                break
        else:
            self._counts[-1] += 1
        self._sum += v
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative bucket counts keyed by upper bound, plus sum/count."""
        cum = 0
        buckets: List[Tuple[float, int]] = []
        for bound, c in zip(self.bounds, self._counts):
            cum += c
            buckets.append((bound, cum))
        return {"name": self.name, "help": self.help,
                "buckets": buckets, "sum": self._sum,
                "count": self._count + 0}


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in labels.items())
    return "{%s}" % inner


# flat stats keys -> (metric name, type, help). Counters are cumulative
# totals; everything else from the snapshot is exported as a gauge.
_COUNTERS = {
    "completed_total", "aborted_total", "rejected_total", "decode_steps",
    "prefills", "preemptions", "prefix_hits", "spec_cycles",
    "spec_drafted", "spec_accepted",
}


def render_prometheus(stats: Dict[str, Any],
                      histograms: Iterable[Histogram] = (),
                      info: Optional[Dict[str, Any]] = None,
                      prefix: str = "repro_",
                      labeled: Optional[Dict[str, List[Tuple[
                          Dict[str, Any], float]]]] = None) -> str:
    """The driver stats snapshot + histograms as exposition text.

    ``labeled`` carries multi-sample gauge families —
    ``{metric_name: [(labels, value), ...]}`` — used by the numerics
    observer for per-layer series (one sample per ``{layer=...}``).
    """
    lines: List[str] = []

    def emit(name: str, mtype: str, help_text: str,
             samples: List[Tuple[str, Optional[Dict[str, Any]], float]]):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for suffix, labels, value in samples:
            lines.append(f"{name}{suffix}{_labels(labels)} {_fmt(value)}")

    if info:
        emit(prefix + "build_info", "gauge",
             "Engine build/runtime identity (value is always 1).",
             [("", {k: v for k, v in info.items() if v is not None}, 1.0)])

    for key in sorted(stats):
        value = stats[key]
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        if isinstance(value, float) and math.isnan(value):
            continue  # rates are NaN before the first completion
        mtype = "counter" if key in _COUNTERS else "gauge"
        emit(prefix + key, mtype, f"Engine stat {key!r}.",
             [("", None, float(value))])

    for key in sorted(labeled or ()):
        samples = [("", labels, float(v)) for labels, v in labeled[key]
                   if isinstance(v, (int, float)) and not isinstance(v, bool)
                   and not math.isnan(float(v))]
        if samples:
            emit(prefix + key, "gauge", f"Per-label series {key!r}.", samples)

    for hist in histograms:
        snap = hist.snapshot()
        name = prefix + snap["name"]
        samples: List[Tuple[str, Optional[Dict[str, Any]], float]] = []
        for bound, cum in snap["buckets"]:
            samples.append(("_bucket", {"le": _fmt(bound)}, float(cum)))
        samples.append(("_bucket", {"le": "+Inf"}, float(snap["count"])))
        samples.append(("_sum", None, snap["sum"]))
        samples.append(("_count", None, float(snap["count"])))
        emit(name, "histogram", snap["help"], samples)

    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse exposition text; raise ``ValueError`` on format violations.

    Returns ``{metric_name: {"type": ..., "samples": [(labels, value)]}}``
    where histogram child series (``_bucket``/``_sum``/``_count``) fold
    into their parent metric.
    """
    metrics: Dict[str, Dict[str, Any]] = {}
    typed: Dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            typed[parts[2]] = parts[3]
            metrics.setdefault(parts[2], {"type": parts[3], "samples": []})
            continue
        if line.startswith("#"):
            continue
        # sample: name{labels} value [timestamp]
        if "{" in line:
            name, rest = line.split("{", 1)
            if "}" not in rest:
                raise ValueError(f"line {lineno}: unterminated labels")
            label_str, tail = rest.split("}", 1)
            labels = {}
            for part in filter(None, label_str.split(",")):
                if "=" not in part:
                    raise ValueError(f"line {lineno}: bad label {part!r}")
                k, v = part.split("=", 1)
                labels[k.strip()] = v.strip().strip('"')
            value_str = tail.split()[0] if tail.split() else ""
        else:
            fields = line.split()
            if len(fields) < 2:
                raise ValueError(f"line {lineno}: sample missing value")
            name, value_str = fields[0], fields[1]
            labels = {}
        name = name.strip()
        try:
            value = float(value_str)
        except ValueError:
            raise ValueError(
                f"line {lineno}: non-numeric value {value_str!r}") from None
        parent = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and typed.get(name[:-len(suffix)]) == \
                    "histogram":
                parent = name[:-len(suffix)]
                break
        if parent not in typed:
            raise ValueError(
                f"line {lineno}: sample {name!r} precedes its TYPE line")
        metrics[parent]["samples"].append(
            ({**labels, "__name__": name}, value))

    # histogram completeness: +Inf bucket, _sum, _count, monotone buckets
    for name, meta in metrics.items():
        if meta["type"] != "histogram":
            continue
        series = {s["__name__"] for s, _ in meta["samples"]}
        for want in (name + "_sum", name + "_count"):
            if want not in series:
                raise ValueError(f"histogram {name} missing {want}")
        buckets = [(s.get("le"), v) for s, v in meta["samples"]
                   if s["__name__"] == name + "_bucket"]
        if not any(le == "+Inf" for le, _ in buckets):
            raise ValueError(f"histogram {name} missing +Inf bucket")
        counts = [v for _, v in buckets]
        if counts != sorted(counts):
            raise ValueError(f"histogram {name} buckets not cumulative")
    return metrics
