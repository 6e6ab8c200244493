"""Overload brownout ladder of the serving router, as in
``ray_lightning_tpu/serve/brownout.py``.

A small hysteresis state machine the router feeds with fleet utilization
(``serve/capacity.py::aggregate_fleet`` over the replicas' beat capacity
blocks).  Levels, each subsuming the one below:

* **0 — healthy**: no intervention.
* **1 — degrade**: speculative draft lanes off (``spec -> 0``).
* **2 — clamp**: ``max_new_tokens`` capped at ``max_new_cap`` too.
* **3 — shed**: best-effort traffic (``priority < 1``) gets the typed
  retryable ``shed`` reply; one half-open probe per ``probe_every_s`` is
  let through, so the ladder senses recovery.

Climbing rung ``i`` needs utilization >= ``enter[i]``; descending needs
utilization < ``enter[i] - exit_margin``; every move waits out
``min_dwell_s`` since the last (the first climb off level 0 is at once).
Host only; the clock is injectable for deterministic tests.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

__all__ = ["BrownoutLadder"]


class BrownoutLadder:
    """See module docstring.  Not thread-safe by itself — the router
    only touches it under its own control-plane lock."""

    def __init__(
        self,
        *,
        enter: Sequence[float] = (0.85, 0.95, 1.0),
        exit_margin: float = 0.10,
        min_dwell_s: float = 2.0,
        probe_every_s: float = 5.0,
        max_new_cap: int = 64,
        clock: Callable[[], float] = time.monotonic,
    ):
        if len(enter) != 3:
            raise ValueError(f"enter must name 3 rung thresholds: {enter}")
        if sorted(enter) != list(enter):
            raise ValueError(f"enter thresholds must be ascending: {enter}")
        if exit_margin <= 0:
            raise ValueError(f"exit_margin must be > 0: {exit_margin}")
        if max_new_cap < 1:
            raise ValueError(f"max_new_cap must be >= 1: {max_new_cap}")
        self.enter = tuple(float(e) for e in enter)
        self.exit_margin = float(exit_margin)
        self.min_dwell_s = float(min_dwell_s)
        self.probe_every_s = float(probe_every_s)
        self.max_new_cap = int(max_new_cap)
        self._clock = clock
        self.level = 0
        self._last_change: Optional[float] = None
        self._last_probe: Optional[float] = None

    def observe(self, utilization: float,
                now: Optional[float] = None) -> int:
        """Ingest one fleet-utilization sample; returns the (possibly
        updated) level.  Moves one rung at a time: a single wild sample
        cannot jump a healthy fleet straight to shedding."""
        now = self._clock() if now is None else now
        dwelt = (self._last_change is None
                 or now - self._last_change >= self.min_dwell_s)
        if self.level < 3 and utilization >= self.enter[self.level]:
            # First climb off healthy is immediate — overload response
            # latency matters more than flap protection at level 0.
            if dwelt or self.level == 0:
                self.level += 1
                self._last_change = now
        elif self.level > 0 \
                and utilization < self.enter[self.level - 1] \
                - self.exit_margin:
            if dwelt:
                self.level -= 1
                self._last_change = now
        return self.level

    def allow_probe(self, now: Optional[float] = None) -> bool:
        """At shed level, admit one best-effort request per
        ``probe_every_s`` as the half-open recovery probe."""
        now = self._clock() if now is None else now
        if self._last_probe is None \
                or now - self._last_probe >= self.probe_every_s:
            self._last_probe = now
            return True
        return False
