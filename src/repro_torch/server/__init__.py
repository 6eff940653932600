"""Online serving gateway over the continuous-batching engine.

Modules
-------
sampling  — ``SamplingParams`` and the batch sampler (K6)
protocol  — OpenAI-style JSON request/response schema for the HTTP API
sse       — server-sent-events framing (encode + incremental parser)
driver    — ``EngineDriver``: the thread that owns the engine, with a
            thread-safe submit/abort mailbox and admission control
app       — the asyncio HTTP front-end (``Gateway``)

``driver`` and ``app`` are imported lazily: ``serving.engine`` imports
``repro_torch.server.sampling``, and an eager import here would close the
cycle back through ``driver -> serving``.
"""
from repro_torch.server.sampling import GREEDY, SamplingParams, sample_logits

__all__ = ["GREEDY", "SamplingParams", "sample_logits",
           "EngineDriver", "Gateway"]

_LAZY = {"EngineDriver": "repro_torch.server.driver",
         "Gateway": "repro_torch.server.app"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
