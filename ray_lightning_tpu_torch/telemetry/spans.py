"""A bounded span recorder, as in ``ray_lightning_tpu/telemetry/spans.py``:
the part of its ``SpanTracer`` the serving engine uses.

A :class:`SpanTracer` keeps already-measured spans in a ring buffer (the
newest win; ``dropped`` counts evictions) and exports them as JSONL, one
span object a line, the JAX package's ``validate_span`` shape.  It is
off unless enabled: a disabled tracer's ``record`` returns at once, so
instrumentation left in the serve loop costs an attribute check.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = ["Span", "SpanTracer"]


class Span(NamedTuple):
    name: str
    ts: float        # seconds at open
    dur: float       # seconds
    rank: int
    tid: int         # python thread id
    depth: int       # nesting depth within its thread (0 = top level)
    args: Optional[Dict[str, Any]] = None


class SpanTracer:
    """Bounded ring buffer of :class:`Span` records for one process.
    Callers pass each span's start: ``time.time`` seconds for spans that
    other processes' exports are stitched with."""

    def __init__(self, enabled: bool = False, maxlen: int = 4096,
                 rank: int = 0):
        if maxlen < 1:
            raise ValueError("maxlen must be >= 1")
        self.enabled = enabled
        self.rank = rank
        self.maxlen = maxlen
        self._buf: collections.deque = collections.deque(maxlen=maxlen)
        self._recorded = 0

    def record(self, name: str, ts: float, dur: float, depth: int = 0,
               args: Optional[Dict[str, Any]] = None) -> None:
        """Append an already-measured span.  No-op when disabled."""
        if not self.enabled:
            return
        self._buf.append(
            Span(name, ts, dur, self.rank,
                 threading.get_ident() & 0x7FFFFFFF, depth, args)
        )
        self._recorded += 1

    def events(self) -> List[Span]:
        return list(self._buf)

    @property
    def dropped(self) -> int:
        return self._recorded - len(self._buf)

    def export_jsonl(self, path: str) -> int:
        """One span per line; returns the number of spans written."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        spans = self.events()
        with open(path, "w") as f:
            for s in spans:
                d = {"name": s.name, "ts": s.ts, "dur": s.dur,
                     "rank": s.rank, "tid": s.tid, "depth": s.depth}
                if s.args:
                    d["args"] = s.args
                f.write(json.dumps(d) + "\n")
        return len(spans)
