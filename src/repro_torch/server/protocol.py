"""OpenAI-style JSON schema for the gateway's completion API (the port's
copy of ``repro.server.protocol``: the same validation, status codes and
bodies, byte for byte).

The reproduction has no tokenizer, so ``prompt`` is a list of token ids
(or a list of per-position id rows for multi-codebook models) and
responses carry ``token_ids`` instead of text. Everything else follows
the ``/v1/completions`` shape: ``max_tokens``, ``temperature`` /
``top_k`` / ``top_p`` / ``seed`` / ``stop`` sampling knobs, ``stream``
for SSE, and per-choice ``finish_reason`` ("stop" / "length" /
"capacity" / "aborted").
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.server.sampling import SamplingParams

__all__ = ["ProtocolError", "CompletionRequest", "parse_completion",
           "completion_body", "chunk_body", "error_body"]


class ProtocolError(ValueError):
    """Client error -> HTTP status (400 unless told otherwise)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


@dataclasses.dataclass(frozen=True)
class CompletionRequest:
    prompt: List
    max_tokens: int
    sampling: SamplingParams
    stream: bool = False


def _require_int(obj: Dict, key: str, default, *, lo=None, hi=None):
    val = obj.get(key, default)
    if isinstance(val, bool) or not isinstance(val, (int, float)) \
            or int(val) != val:
        raise ProtocolError(f"{key!r} must be an integer, got {val!r}")
    val = int(val)
    if lo is not None and val < lo:
        raise ProtocolError(f"{key!r} must be >= {lo}, got {val}")
    if hi is not None and val > hi:
        raise ProtocolError(f"{key!r} must be <= {hi}, got {val}")
    return val


def _token_list(val: Any, what: str) -> List:
    if not isinstance(val, list) or not val:
        raise ProtocolError(f"{what} must be a non-empty list of token ids")
    if all(isinstance(t, int) and not isinstance(t, bool) for t in val):
        return val
    # multi-codebook prompts: one row of ids per position
    if all(isinstance(row, list) and row
           and all(isinstance(t, int) and not isinstance(t, bool)
                   for t in row) for row in val):
        width = len(val[0])
        if any(len(row) != width for row in val):
            raise ProtocolError(f"{what} codebook rows must share one width")
        return val
    raise ProtocolError(f"{what} must hold token ids (ints or int rows)")


def parse_completion(body: bytes) -> CompletionRequest:
    """Validate a ``POST /v1/completions`` body; raises ProtocolError."""
    try:
        obj = json.loads(body or b"")
    except json.JSONDecodeError as e:
        raise ProtocolError(f"request body is not valid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError("request body must be a JSON object")

    prompt = _token_list(obj.get("prompt"), "'prompt'")
    max_tokens = _require_int(obj, "max_tokens", 16, lo=1)
    temperature = obj.get("temperature", 0.0)
    top_p = obj.get("top_p", 1.0)
    if not isinstance(temperature, (int, float)) or isinstance(temperature, bool):
        raise ProtocolError(f"'temperature' must be a number, got {temperature!r}")
    if not isinstance(top_p, (int, float)) or isinstance(top_p, bool):
        raise ProtocolError(f"'top_p' must be a number, got {top_p!r}")
    top_k = _require_int(obj, "top_k", 0, lo=0)
    seed = _require_int(obj, "seed", 0)
    stop = obj.get("stop", [])
    if stop is None:
        stop = []
    if isinstance(stop, int) and not isinstance(stop, bool):
        stop = [stop]
    if not isinstance(stop, list) or any(
            isinstance(t, bool) or not isinstance(t, int) for t in stop):
        raise ProtocolError("'stop' must be a token id or list of token ids")
    stream = obj.get("stream", False)
    if not isinstance(stream, bool):
        raise ProtocolError(f"'stream' must be a boolean, got {stream!r}")
    try:
        sampling = SamplingParams(temperature=float(temperature),
                                  top_k=top_k, top_p=float(top_p),
                                  seed=seed, stop=frozenset(stop))
    except ValueError as e:
        raise ProtocolError(str(e)) from None
    return CompletionRequest(prompt=prompt, max_tokens=max_tokens,
                             sampling=sampling, stream=stream)


# ---------------------------------------------------------------------------
# response bodies


def _choice(token_ids: List, finish_reason: Optional[str],
            delta: bool) -> Dict:
    key = "delta" if delta else "token_ids"
    val = {"token_ids": token_ids} if delta else token_ids
    return {"index": 0, key: val, "finish_reason": finish_reason}


def completion_body(rid: int, model: str, prompt_tokens: int,
                    token_ids: List, finish_reason: str,
                    spec: Optional[dict] = None) -> str:
    """Terminal unary body. ``spec`` (when the engine speculated for this
    request) lands under ``usage.speculation`` — cycles the request rode,
    draft tokens scored for it, and how many the verify pass accepted."""
    usage = {"prompt_tokens": prompt_tokens,
             "completion_tokens": len(token_ids),
             "total_tokens": prompt_tokens + len(token_ids)}
    if spec is not None:
        usage["speculation"] = spec
    return json.dumps({
        "id": f"cmpl-{rid}", "object": "text_completion", "model": model,
        "choices": [_choice(token_ids, finish_reason, delta=False)],
        "usage": usage,
    })


def chunk_body(rid: int, model: str, token_ids: List,
               finish_reason: Optional[str] = None) -> str:
    """One SSE chunk: the freshly produced token(s), finish_reason on the
    terminal chunk only."""
    return json.dumps({
        "id": f"cmpl-{rid}", "object": "text_completion.chunk",
        "model": model,
        "choices": [_choice(token_ids, finish_reason, delta=True)],
    })


def error_body(message: str, status: int) -> str:
    kind = {429: "rate_limit_exceeded", 503: "server_unavailable",
            404: "not_found"}.get(status, "invalid_request_error")
    return json.dumps({"error": {"message": message, "type": kind,
                                 "code": status}})
