"""Continuous-batching serving over the packed-LNS decode path."""
from repro_torch.serving.engine import DEFAULT_BUCKETS, Engine
from repro_torch.serving.metrics import RequestMetrics, summarize
from repro_torch.serving.request import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import BlockAllocator, Scheduler
from repro_torch.serving.trace import max_trace_len, synthetic_trace

__all__ = ["BlockAllocator", "DEFAULT_BUCKETS", "Engine", "Request",
           "RequestMetrics", "RequestQueue", "RequestState", "Scheduler",
           "max_trace_len", "summarize", "synthetic_trace"]
