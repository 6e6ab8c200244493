"""Trace context across process hops, as in
``ray_lightning_tpu/telemetry/propagate.py``.

A :class:`TraceContext` is three strings: ``trace_id`` (the request's
identity on every hop; for a serve request it is the rid, so a
recompute after preemption lands in the same trace), ``span_id`` (the
span that caused this hop) and ``parent_span_id``.  It rides wire frames
as an optional ``"trace"`` dict (:func:`inject` / :func:`extract`, the
JAX package's ``validate_trace_context`` shape), and spans record the
linkage in their args (:func:`trace_args`), which is what the JAX
package's ``trace_collect`` stitches per-process exports on.  Root span
ids are derived (``<trace_id>.root``), so any process that knows the
trace id can parent a span to the root.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, NamedTuple, Optional

__all__ = [
    "TraceContext",
    "new_span_id",
    "root_context",
    "child_context",
    "inject",
    "extract",
    "sent_ts",
    "trace_args",
]


class TraceContext(NamedTuple):
    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None

    @property
    def root_span_id(self) -> str:
        return self.trace_id + ".root"


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def root_context(trace_id: str) -> TraceContext:
    """The root of a trace.  The span id is derived from the trace id,
    so every process agrees on it without coordination."""
    trace_id = str(trace_id)
    return TraceContext(trace_id, trace_id + ".root", None)


def child_context(ctx: TraceContext,
                  span_id: Optional[str] = None) -> TraceContext:
    """A fresh span under ``ctx`` (the caller's span becomes the
    parent)."""
    return TraceContext(ctx.trace_id, span_id or new_span_id(),
                        ctx.span_id)


def inject(item: Dict[str, Any], ctx: Optional[TraceContext],
           ts: Optional[float] = None) -> Dict[str, Any]:
    """Stamp ``ctx`` into a wire frame (no-op when ``ctx`` is None).
    ``ts`` (wall-clock seconds, default now) records the SEND time so
    the consumer can book the transfer interval as a span without a
    second round trip."""
    if ctx is None:
        return item
    trace: Dict[str, Any] = {
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id,
        "ts": time.time() if ts is None else ts,
    }
    if ctx.parent_span_id is not None:
        trace["parent_span_id"] = ctx.parent_span_id
    item["trace"] = trace
    return item


def extract(item: Any) -> Optional[TraceContext]:
    """Recover the context a frame carries (None when absent or
    malformed — an old producer's frame must never fail the consumer)."""
    if not isinstance(item, dict):
        return None
    trace = item.get("trace")
    if not isinstance(trace, dict):
        return None
    trace_id, span_id = trace.get("trace_id"), trace.get("span_id")
    if not isinstance(trace_id, str) or not isinstance(span_id, str):
        return None
    parent = trace.get("parent_span_id")
    return TraceContext(trace_id, span_id,
                        parent if isinstance(parent, str) else None)


def sent_ts(item: Any) -> Optional[float]:
    """The producer-stamped wall-clock send time of a traced frame."""
    if not isinstance(item, dict):
        return None
    trace = item.get("trace")
    if not isinstance(trace, dict):
        return None
    ts = trace.get("ts")
    return float(ts) if isinstance(ts, (int, float)) else None


def trace_args(ctx: TraceContext, **extra: Any) -> Dict[str, Any]:
    """Span-args dict carrying the trace linkage (what
    ``trace_collect`` stitches on)."""
    args: Dict[str, Any] = {
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id,
    }
    if ctx.parent_span_id is not None:
        args["parent_span_id"] = ctx.parent_span_id
    args.update(extra)
    return args
