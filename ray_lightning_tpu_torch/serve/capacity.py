"""The serving headroom oracle, as in ``ray_lightning_tpu/serve/capacity.py``.

One :class:`CapacityOracle` per engine feeds a :class:`TimeSeriesStore`
from the engine's cheap stats slice at every export tick, then derives a
decode-tick cost model (``tick_us = c + h·busy`` fitted on per-bin deltas
of ``decode_steps``/``decode_us``/``tokens_out``/``admitted``/
``admit_us``), the saturation throughput and headroom, the request-rate
knee (:meth:`CapacityOracle.predict_saturation_rps`), the free-block
trend's ETA to exhaustion, and the queue-wait slope and rejection rate.
Snapshots have the JAX package's ``capacity_snapshot`` shape and ride
the serve snapshot's ``capacity`` block; :func:`aggregate_fleet` folds
several into a fleet view.  The ``recompiles`` series counts CUDA-graph
captures on the port (0 on the eager server).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ray_lightning_tpu_torch.telemetry.timeseries import TimeSeriesStore

__all__ = ["CapacityOracle", "aggregate_fleet"]


class CapacityOracle:
    """Per-engine headroom oracle over a bounded time-series store."""

    def __init__(self, interval_s: float = 1.0, window_s: float = 30.0,
                 capacity: int = 600,
                 clock: Optional[Callable[[], float]] = None,
                 store: Optional[TimeSeriesStore] = None):
        self.store = store if store is not None else TimeSeriesStore(
            interval_s=interval_s, capacity=capacity, clock=clock,
        )
        self.window_s = float(window_s)
        import time

        self._clock = clock if clock is not None else time.time
        self.last: Optional[dict] = None  # newest snapshot() result
        self._model: Optional[dict] = None  # newest tick-cost fit

    # -- ingestion -----------------------------------------------------------
    def observe(self, snap: dict, recompiles: Optional[int] = None,
                ts: Optional[float] = None) -> None:
        """Feed one ``ServeStats`` snapshot (and optionally the
        recompile total: CUDA-graph captures on the port) into the store."""
        if ts is None:
            ts = snap.get("ts", self._clock())
        counters = snap.get("counters", {})
        for name in ("tokens_out", "completed", "submitted",
                     "rejected", "preempted", "admitted",
                     "decode_steps", "decode_us", "admit_us"):
            self.store.observe(name, counters.get(name, 0),
                               kind="counter", ts=ts)
        gauges = snap.get("gauges", {})
        for name in ("blocks_free", "queue_depth", "slots_active"):
            if name in gauges:
                self.store.observe(name, gauges[name], kind="gauge",
                                   ts=ts)
        for name in ("num_slots", "num_blocks"):
            if name in gauges:
                self.store.observe(name, gauges[name], kind="gauge",
                                   ts=ts)
        wait = snap.get("latency", {}).get("queue_wait", {})
        if wait.get("n"):
            self.store.observe("queue_wait_p50_ms", wait["p50_ms"],
                               kind="gauge", ts=ts)
        if recompiles is not None:
            self.store.observe("recompiles", recompiles,
                               kind="counter", ts=ts)

    # -- the oracle ----------------------------------------------------------
    def _tick_model(self, window_s: float) -> Optional[dict]:
        """Affine decode-tick cost over the window's bins:
        ``tick_us = c + h * busy`` fitted by least squares on per-bin
        counter deltas, plus the mean per-admission cost.  ``None``
        until the engine has fed enough tick counters — synthetic
        stores and pre-plane snapshots fall back to the sampled-gauge
        service estimate in :meth:`snapshot`."""
        names = ("decode_steps", "decode_us", "tokens_out",
                 "admitted", "admit_us")
        grid: dict = {}
        for name in names:
            for ts, v in self.store.series(name, window_s):
                grid.setdefault(ts, {})[name] = v
        rows = [grid[ts] for ts in sorted(grid)
                if len(grid[ts]) == len(names)]
        pairs = []          # (busy slots, tick µs) per bin
        admit_costs = []    # per-bin µs per admission
        admitted = 0.0
        for prev, row in zip(rows, rows[1:]):
            d = {k: row[k] - prev[k] for k in names}
            if any(v < 0 for v in d.values()):
                continue    # counter reset mid-window
            if d["decode_steps"] > 0 and d["decode_us"] > 0:
                # First tokens land at admission, not on decode ticks.
                busy = (d["tokens_out"] - d["admitted"]) \
                    / d["decode_steps"]
                if busy > 0:
                    pairs.append(
                        (busy, d["decode_us"] / d["decode_steps"])
                    )
            if d["admitted"] > 0 and d["admit_us"] > 0:
                admitted += d["admitted"]
                admit_costs.append(d["admit_us"] / d["admitted"])
        if len(pairs) < 4 or admitted <= 0:
            return None
        # Robust estimators throughout — a transient host-load burst
        # poisons a handful of bins, and a mean-based fit would carry
        # that straight into the predicted knee.
        n = len(pairs)
        spread = max(b for b, _ in pairs) - min(b for b, _ in pairs)
        h = 0.0
        if spread >= 1.0:
            # Theil–Sen: median of pairwise slopes across bins with
            # real occupancy separation.  A saturated window (every
            # bin full-width) degrades to the median tick cost below.
            slopes = []
            for i in range(n):
                b_i, t_i = pairs[i]
                for j in range(i + 1, n):
                    b_j, t_j = pairs[j]
                    if abs(b_j - b_i) >= 0.5:
                        slopes.append((t_j - t_i) / (b_j - b_i))
            if len(slopes) >= 8:
                slopes.sort()
                h = max(slopes[len(slopes) // 2], 0.0)
        residuals = sorted(t - h * b for b, t in pairs)
        c = max(residuals[n // 2], 0.0)
        if c <= 0.0 and h <= 0.0:
            return None
        admit_costs.sort()
        admit_us = admit_costs[len(admit_costs) // 2]
        return {"c_us": c, "h_us": h,
                "admit_s": admit_us / 1e6, "bins": n}

    def snapshot(self, window_s: Optional[float] = None) -> dict:
        """One schema-shaped ``capacity_snapshot``; cached on
        ``self.last`` so ``ServeEngine.snapshot()`` (and therefore
        every beat) attaches it without recomputing."""
        w = window_s if window_s is not None else self.window_s
        store = self.store
        tokens_per_s = store.rate("tokens_out", w) or 0.0
        num_slots = store.last("num_slots") or 0.0
        model = self._tick_model(w)
        self._model = model
        service = None
        capacity_tps = None
        if model is not None and num_slots > 0:
            # Roofline from measured phase costs: a full-width tick
            # costs c + h·S µs and lands S tokens.
            t_full = (model["c_us"] + model["h_us"] * num_slots) / 1e6
            if t_full > 0:
                capacity_tps = num_slots / t_full
                service = capacity_tps / num_slots
        if capacity_tps is None:
            busy = store.mean("slots_active", w)
            if busy is not None and busy > 0 and tokens_per_s > 0:
                service = tokens_per_s / busy
            capacity_tps = service * num_slots if service else None
        headroom = None
        utilization = None
        if capacity_tps:
            headroom = max(capacity_tps - tokens_per_s, 0.0)
            utilization = min(max(tokens_per_s / capacity_tps, 0.0), 1.0)
        submitted = store.rate("submitted", w)
        rejected = store.rate("rejected", w)
        rejection_rate = 0.0
        if submitted and submitted > 0:
            rejection_rate = min(max((rejected or 0.0) / submitted,
                                     0.0), 1.0)
        eta = store.eta_to("blocks_free", 0.0, w)
        if eta is not None and eta < 0:
            eta = None  # already past the threshold bin — not a trend
        snap = {
            "type": "capacity_snapshot",
            "ts": self._clock(),
            "window_s": w,
            "tokens_per_s": tokens_per_s,
            "service_rate_per_slot": service,
            "capacity_tokens_per_s": capacity_tps,
            "headroom_tokens_per_s": headroom,
            "utilization": utilization,
            "kv_exhaustion_eta_s": eta,
            "queue_wait_slope_ms_per_s": store.slope(
                "queue_wait_p50_ms", w
            ),
            "queue_depth": store.last("queue_depth") or 0.0,
            "rejection_rate": rejection_rate,
        }
        self.last = snap
        return snap

    def predict_saturation_rps(self, max_new_tokens: int,
                               window_s: Optional[float] = None
                               ) -> Optional[float]:
        """The request-rate knee.  With a tick-cost fit: balance the
        engine-time budget — every request charges one measured
        admission (prefill dispatch + TTFT sync) plus its share of
        ``max_new−1`` full-width decode ticks.  Without one: token
        capacity over tokens per request.  ``None`` until the oracle
        has measured enough — it refuses to guess before it has
        data."""
        snap = self.snapshot(window_s)
        capacity_tps = snap["capacity_tokens_per_s"]
        if not capacity_tps or max_new_tokens < 1:
            return None
        model = self._model
        num_slots = self.store.last("num_slots") or 0.0
        if model is not None and num_slots > 0:
            tick_s = (model["c_us"] + model["h_us"] * num_slots) / 1e6
            per_req = model["admit_s"] + \
                max(max_new_tokens - 1, 0) * tick_s / num_slots
            if per_req > 0:
                return 1.0 / per_req
        return capacity_tps / max_new_tokens


def aggregate_fleet(blocks: List[Optional[dict]]) -> Optional[dict]:
    """Fold per-replica ``capacity_snapshot`` blocks into the
    fleet-wide view the router exports: throughput and capacity sum;
    utilization is load-weighted; the ETA is the fleet's WORST (the
    first replica to exhaust KV is the fleet event)."""
    live = [b for b in blocks if isinstance(b, dict)]
    if not live:
        return None
    tokens = sum(b.get("tokens_per_s") or 0.0 for b in live)
    caps = [b.get("capacity_tokens_per_s") for b in live]
    capacity = sum(c for c in caps if c) or None
    etas = [b.get("kv_exhaustion_eta_s") for b in live]
    etas = [e for e in etas if isinstance(e, (int, float))]
    headroom = max(capacity - tokens, 0.0) if capacity else None
    utilization = None
    if capacity:
        utilization = min(max(tokens / capacity, 0.0), 1.0)
    return {
        "replicas_reporting": len(live),
        "tokens_per_s": tokens,
        "capacity_tokens_per_s": capacity,
        "headroom_tokens_per_s": headroom,
        "utilization": utilization,
        "kv_exhaustion_eta_s": min(etas) if etas else None,
    }
