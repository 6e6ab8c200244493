"""SLO stats for the serving plane: counters, TTFT, inter-token latency
and the critical-path phases.

Latency families are bounded reservoirs (newest N): a serving process
runs for days, and percentiles over the recent window are what an
operator acts on.  The snapshot keeps the JAX package's key names
(``ray_lightning_tpu/serve/metrics.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["ServeStats", "percentile"]

# Newest-N window per latency family.
_RESERVOIR = 4096

_COUNTER_KEYS = (
    "submitted", "admitted", "completed", "rejected", "expired",
    "preempted", "tokens_out", "prefills", "decode_steps",
)


def percentile(values: List[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (``p`` in [0, 100]); None on empty."""
    if not values:
        return None
    vals = sorted(values)
    k = max(0, min(len(vals) - 1, int(round(p / 100.0 * len(vals))) - 1))
    if p <= 0:
        k = 0
    return vals[k]


class _Reservoir:
    __slots__ = ("_vals", "_n", "_cap")

    def __init__(self, cap: int = _RESERVOIR):
        self._vals: List[float] = []
        self._n = 0
        self._cap = cap

    def add(self, v: float) -> None:
        self._n += 1
        self._vals.append(v)
        if len(self._vals) > self._cap:
            del self._vals[: len(self._vals) - self._cap]

    def summary_ms(self) -> Optional[Dict[str, float]]:
        if not self._vals:
            return None
        return {
            "n": self._n,
            "p50_ms": round(percentile(self._vals, 50) * 1e3, 3),
            "p99_ms": round(percentile(self._vals, 99) * 1e3, 3),
            "max_ms": round(max(self._vals) * 1e3, 3),
        }

    def phase_summary_ms(self) -> Optional[Dict[str, float]]:
        """The per-phase spelling (p50/p95: a p99 over the window is
        mostly noise for the short phases)."""
        if not self._vals:
            return None
        return {
            "n": self._n,
            "p50_ms": round(percentile(self._vals, 50) * 1e3, 3),
            "p95_ms": round(percentile(self._vals, 95) * 1e3, 3),
        }


class ServeStats:
    """Thread-safe counters, latency reservoirs and gauges, fed by the
    engine's ``note_*`` calls; any thread may :meth:`snapshot`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {k: 0 for k in _COUNTER_KEYS}
        self._ttft = _Reservoir()
        self._token = _Reservoir()       # inter-token latency, decode ticks
        self._queue_wait = _Reservoir()  # arrival → admission
        self._e2e = _Reservoir()         # arrival → finished
        # Critical-path phase reservoirs (queue_wait, prefill_compute,
        # first_token), created by note_phase: engines that do not trace
        # carry no "phases" block.
        self._phases: Dict[str, _Reservoir] = {}
        # Per-adapter (tenant) accounting, created on first use so
        # engines without an adapter pool carry no "adapters" block.
        self._adapters: Dict[str, Dict[str, int]] = {}
        # The prefix-cache block, set by set_prefix on engines with the
        # cache (others carry no "prefix" block).
        self._prefix: Optional[Dict[str, float]] = None
        self.gauges: Dict[str, float] = {}

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def note_admitted(self, wait_s: float) -> None:
        with self._lock:
            self.counters["admitted"] += 1
            self._queue_wait.add(wait_s)

    def note_first_token(self, ttft_s: float) -> None:
        with self._lock:
            self._ttft.add(ttft_s)

    def note_token_latency(self, dt_s: float, n_tokens: int = 1) -> None:
        """One decode tick's wall interval, attributed to each of the
        ``n_tokens`` it emitted."""
        with self._lock:
            self.counters["tokens_out"] += n_tokens
            for _ in range(n_tokens):
                self._token.add(dt_s)

    def note_completed(self, e2e_s: float) -> None:
        with self._lock:
            self.counters["completed"] += 1
            self._e2e.add(e2e_s)

    def note_spec_slot(self, drafted: int, accepted: int,
                       emitted: int) -> None:
        """One slot's accounting for one speculative verify tick; the
        spec counters appear on the first call."""
        if accepted > drafted:
            raise ValueError(
                f"spec accounting bug: accepted {accepted} > drafted "
                f"{drafted}"
            )
        with self._lock:
            for key, n in (("spec_drafted", drafted),
                           ("spec_accepted", accepted),
                           ("spec_emitted", emitted)):
                self.counters[key] = self.counters.get(key, 0) + n

    def note_adapter(self, name: str, tokens: int = 0,
                     completed: int = 0) -> None:
        """Per-tenant accounting for one emission or completion."""
        with self._lock:
            entry = self._adapters.setdefault(
                name, {"tokens_out": 0, "completed": 0}
            )
            entry["tokens_out"] += tokens
            entry["completed"] += completed

    def note_phase(self, phase: str, dur_s: float) -> None:
        """One request's interval in one critical-path phase (fed where
        the engine records its spans)."""
        with self._lock:
            res = self._phases.get(phase)
            if res is None:
                res = self._phases[phase] = _Reservoir()
            res.add(dur_s)

    def adapter_token_counts(self) -> Dict[str, int]:
        """Lifetime emitted tokens per adapter (the fairness gauge)."""
        with self._lock:
            return {k: v["tokens_out"] for k, v in self._adapters.items()}

    def set_gauges(self, **gauges: float) -> None:
        with self._lock:
            self.gauges.update(gauges)

    def set_prefix(self, **fields: float) -> None:
        """Replace the prefix-cache block (the engine feeds
        ``PrefixIndex.stats()`` at each gauge refresh)."""
        with self._lock:
            self._prefix = dict(fields)

    def capacity_view(self) -> Dict[str, object]:
        """The cheap slice the SLO and capacity plane reads each export
        tick: counters, gauges and the queue wait's p50 over the newest
        512 admissions (``snapshot()`` sorts every reservoir)."""
        with self._lock:
            out: Dict[str, object] = {
                "ts": time.time(),
                "counters": dict(self.counters),
                "gauges": {k: float(v) for k, v in self.gauges.items()},
            }
            recent = self._queue_wait._vals[-512:]
        p50 = percentile(recent, 50)
        out["latency"] = {} if p50 is None else {
            "queue_wait": {"n": len(recent),
                           "p50_ms": round(p50 * 1e3, 3)},
        }
        return out

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                "ts": time.time(),
                "counters": dict(self.counters),
                "gauges": {k: float(v) for k, v in self.gauges.items()},
            }
            latency = {}
            for name, res in (("ttft", self._ttft),
                              ("token", self._token),
                              ("queue_wait", self._queue_wait),
                              ("e2e", self._e2e)):
                s = res.summary_ms()
                if s is not None:
                    latency[name] = s
            out["latency"] = latency
            if self._phases:
                phases = {}
                for name, res in self._phases.items():
                    s = res.phase_summary_ms()
                    if s is not None:
                        phases[name] = s
                out["phases"] = phases
            if self._adapters:
                out["adapters"] = {
                    name: dict(entry)
                    for name, entry in self._adapters.items()
                }
            if self._prefix is not None:
                out["prefix"] = dict(self._prefix)
            return out
