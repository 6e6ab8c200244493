"""A bounded fixed-interval time-series store, as in
``ray_lightning_tpu/telemetry/timeseries.py``.

Each named series is a ring of ``(bin, payload)`` bins, one bin per
``interval_s`` of the injected clock: memory is bounded per series
whatever the observation rate.  ``counter`` bins keep the latest
cumulative value (rates come from differences, reset-safe), ``gauge``
bins the last write, ``hist`` bins a bounded sample list merged for
windowed percentiles.  :meth:`TimeSeriesStore.points` yields the JAX
package's ``timeseries_point`` shape.  The SLO evaluator
(``slo.py``) and the capacity oracle (``serve/capacity.py``) read it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["TimeSeriesStore"]

_KINDS = ("counter", "gauge", "hist")
# Per-bin sample bound for hist series: windowed percentiles stay
# meaningful while a pathological producer cannot balloon one bin.
_HIST_BIN_SAMPLES = 256


class _Series:
    """One named series: a ring of fixed-interval bins."""

    __slots__ = ("kind", "bins")

    def __init__(self, kind: str, capacity: int):
        self.kind = kind
        # (bin_index, payload): payload is a float for counter/gauge,
        # a bounded list of floats for hist.
        self.bins: deque = deque(maxlen=capacity)


class TimeSeriesStore:
    """Bounded fixed-interval ring store with windowed queries.

    All public methods are thread-safe: the serve loop observes while
    the SLO evaluator / capacity oracle / bench harness query.
    """

    def __init__(self, interval_s: float = 1.0, capacity: int = 600,
                 clock: Optional[Callable[[], float]] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self._clock = clock if clock is not None else time.time
        self._series: Dict[str, _Series] = {}  # guarded by self._lock
        self._lock = threading.Lock()

    # -- ingestion -----------------------------------------------------------
    def observe(self, name: str, value: float, kind: str = "gauge",
                ts: Optional[float] = None) -> None:
        """Record one observation.  ``counter`` values are CUMULATIVE
        (monotonic totals; rates come from :meth:`rate`), ``gauge``
        values are instantaneous, ``hist`` values are individual
        samples merged for windowed percentiles."""
        if kind not in _KINDS:
            raise ValueError(f"unknown series kind {kind!r}")
        if ts is None:
            ts = self._clock()
        idx = int(ts // self.interval_s)
        v = float(value)
        with self._lock:
            series = self._series.get(name)
            if series is None:
                series = self._series[name] = _Series(kind, self.capacity)
            elif series.kind != kind:
                raise ValueError(
                    f"series {name!r} is a {series.kind}, observed as "
                    f"{kind}"
                )
            bins = series.bins
            if bins and bins[-1][0] == idx:
                if kind == "hist":
                    samples = bins[-1][1]
                    if len(samples) < _HIST_BIN_SAMPLES:
                        samples.append(v)
                else:
                    # counter: latest cumulative wins; gauge: last
                    # write wins.  Same update either way.
                    bins[-1] = (idx, v)
            elif bins and bins[-1][0] > idx:
                pass  # out-of-order past the live bin: drop, stay O(1)
            else:
                bins.append((idx, [v] if kind == "hist" else v))

    # -- queries -------------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            series = self._series.get(name)
            return series.kind if series is not None else None

    def last(self, name: str) -> Optional[float]:
        """Latest value (counter: cumulative total; gauge: last write;
        hist: last sample)."""
        with self._lock:
            series = self._series.get(name)
            if series is None or not series.bins:
                return None
            payload = series.bins[-1][1]
            if series.kind == "hist":
                return payload[-1] if payload else None
            return payload

    def series(self, name: str, window_s: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """``(bin_start_ts, value)`` pairs inside the window (hist bins
        surface their per-bin mean)."""
        points = []
        for idx, payload, kind in self._window_bins(name, window_s):
            if kind == "hist":
                if not payload:
                    continue
                value = sum(payload) / len(payload)
            else:
                value = payload
            points.append((idx * self.interval_s, value))
        return points

    def rate(self, name: str, window_s: float) -> Optional[float]:
        """Counter increase per second across the window, reset-safe
        (a cumulative value that shrinks restarts the ramp at 0).
        ``None`` until two bins exist inside the window."""
        bins = self._window_bins(name, window_s)
        if len(bins) < 2:
            return None
        if bins[0][2] != "counter":
            raise ValueError(f"rate() wants a counter, {name!r} is "
                             f"a {bins[0][2]}")
        total = 0.0
        prev = bins[0][1]
        for _, value, _ in bins[1:]:
            total += value - prev if value >= prev else value
            prev = value
        dt = (bins[-1][0] - bins[0][0]) * self.interval_s
        return max(total, 0.0) / dt if dt > 0 else None

    def mean(self, name: str, window_s: float) -> Optional[float]:
        points = self.series(name, window_s)
        if not points:
            return None
        return sum(v for _, v in points) / len(points)

    def percentile(self, name: str, q: float,
                   window_s: float) -> Optional[float]:
        """Windowed nearest-rank percentile.  hist series merge their
        per-bin samples; gauge/counter series rank their bin values."""
        merged: List[float] = []
        for _, payload, kind in self._window_bins(name, window_s):
            if kind == "hist":
                merged.extend(payload)
            else:
                merged.append(payload)
        if not merged:
            return None
        merged.sort()
        rank = max(0, min(len(merged) - 1,
                          int(round(q / 100.0 * (len(merged) - 1)))))
        return merged[rank]

    def slope(self, name: str, window_s: float) -> Optional[float]:
        """Least-squares trend in value-units per second over the
        window.  ``None`` until two bins exist."""
        points = self.series(name, window_s)
        if len(points) < 2:
            return None
        n = len(points)
        mean_t = sum(t for t, _ in points) / n
        mean_v = sum(v for _, v in points) / n
        num = sum((t - mean_t) * (v - mean_v) for t, v in points)
        den = sum((t - mean_t) ** 2 for t, _ in points)
        return num / den if den > 0 else None

    def eta_to(self, name: str, threshold: float,
               window_s: float) -> Optional[float]:
        """Seconds until the series' trend line crosses ``threshold``
        — the KV-exhaustion / queue-overflow predictor.  ``None`` when
        the trend points away from the threshold (or is flat/unknown)."""
        slope = self.slope(name, window_s)
        last = self.last(name)
        if slope is None or last is None:
            return None
        gap = threshold - last
        if gap == 0:
            return 0.0
        if slope == 0 or (gap > 0) != (slope > 0):
            return None  # moving away (or not moving) — no crossing
        return gap / slope

    # -- persistence ---------------------------------------------------------
    def points(self, window_s: Optional[float] = None) -> List[dict]:
        """Schema-shaped ``timeseries_point`` dicts for every bin
        (``telemetry/schema.py::validate_timeseries_point``)."""
        out = []
        for name in self.names():
            for idx, payload, kind in self._window_bins(name, window_s):
                point = {
                    "type": "timeseries_point",
                    "name": name,
                    "kind": kind,
                    "ts": idx * self.interval_s,
                }
                if kind == "hist":
                    if not payload:
                        continue
                    ranked = sorted(payload)
                    point["value"] = ranked[len(ranked) // 2]
                    point["n"] = len(ranked)
                else:
                    point["value"] = payload
                out.append(point)
        return out

    def dump_jsonl(self, path: str,
                   window_s: Optional[float] = None) -> int:
        """Append every (windowed) bin as one JSON line; returns the
        number of points written."""
        import json

        points = self.points(window_s)
        with open(path, "a") as f:
            for point in points:
                f.write(json.dumps(point) + "\n")
        return len(points)

    # -- internals -----------------------------------------------------------
    def _window_bins(self, name: str, window_s: Optional[float]
                     ) -> List[Tuple[int, object, str]]:
        """(bin_index, payload, kind) bins inside the window, oldest
        first.  Copies under the lock so callers iterate lock-free."""
        with self._lock:
            series = self._series.get(name)
            if series is None or not series.bins:
                return []
            kind = series.kind
            bins = list(series.bins)
        if window_s is not None:
            floor = bins[-1][0] - int(window_s // self.interval_s)
            bins = [b for b in bins if b[0] >= floor]
        if kind == "hist":
            return [(idx, list(samples), kind) for idx, samples in bins]
        return [(idx, value, kind) for idx, value in bins]
