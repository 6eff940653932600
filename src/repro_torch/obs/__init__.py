"""Observability of the port, the counterpart of ``repro.obs``: request
span tracing (``spans``), the engine's step timeline (``timeline``),
the engine observer that holds both (``observer``), Prometheus
exposition (``prom``), kernel-time attribution (``kernel_stats``), and
per-layer LNS numerics health with its trace contract (``numerics``);
``python -m repro_torch.obs.validate`` checks exported traces.

Everything is off by default and near free when off: the engine's loop
checks one attribute (``engine.observer is None``) and the kernel
dispatch one module global (``kernel_stats.active() is None``). The
always-on parts, the driver's latency histograms and the ``/metrics``
renderer, run off the step path (once a finished request, once a
scrape).
"""
from repro_torch.obs import kernel_stats
from repro_torch.obs.numerics import NumericsObserver, validate_train_trace
from repro_torch.obs.observer import EngineObserver
from repro_torch.obs.prom import (Histogram, parse_prometheus_text,
                                  render_prometheus)
from repro_torch.obs.spans import SpanRing, validate_chrome_trace
from repro_torch.obs.timeline import StepTimeline

__all__ = [
    "EngineObserver", "NumericsObserver", "SpanRing", "StepTimeline",
    "Histogram", "render_prometheus", "parse_prometheus_text",
    "validate_chrome_trace", "validate_train_trace", "kernel_stats",
]
