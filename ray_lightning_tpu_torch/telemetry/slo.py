"""Declarative SLOs with multi-window burn-rate alerting, as in
``ray_lightning_tpu/telemetry/slo.py``.

An :class:`SloSpec` names an objective (a ratio of two counters, or a
gauge against a threshold), a target and window pairs; the
:class:`SloEvaluator` computes the error budget's burn rate
(``error_rate / (1 - target)``) over each pair and fires only when both
the fast and the slow window burn above the pair's bound.  Alerts are
``slo_alert`` events (``monitor.make_event``; the JAX package's
``validate_slo_alert`` shape), sent once until the spec re-arms.
``snapshot()`` feeds the ``rlt_slo_*`` OpenMetrics family.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.telemetry.timeseries import TimeSeriesStore

__all__ = ["SloSpec", "SloEvaluator", "default_serve_slos"]

# (fast_window_s, slow_window_s, burn-rate threshold) — fire only when
# BOTH windows burn above the threshold.  Scaled to serving horizons.
_DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (10.0, 60.0, 10.0),
    (30.0, 180.0, 4.0),
)


@dataclass(frozen=True)
class SloSpec:
    """One objective.

    ``ratio`` mode: ``error_rate = rate(bad) / rate(total)`` over the
    window (two counter series — e.g. rejected vs submitted).
    ``threshold`` mode: ``error_rate`` = fraction of window bins where
    the gauge exceeds ``threshold`` (e.g. queue-wait p50 above bound).
    """

    name: str
    target: float                       # e.g. 0.99 — budget is 1-target
    mode: str = "ratio"                 # "ratio" | "threshold"
    bad: Optional[str] = None           # ratio: bad-count counter
    total: Optional[str] = None         # ratio: total-count counter
    gauge: Optional[str] = None         # threshold: gauge series name
    threshold: float = 0.0              # threshold: the bound
    windows: Tuple[Tuple[float, float, float], ...] = \
        field(default=_DEFAULT_WINDOWS)

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: target {self.target} outside (0,1)"
            )
        if self.mode == "ratio":
            if not (self.bad and self.total):
                raise ValueError(
                    f"SLO {self.name!r}: ratio mode needs bad= and "
                    f"total= counter names"
                )
        elif self.mode == "threshold":
            if not self.gauge:
                raise ValueError(
                    f"SLO {self.name!r}: threshold mode needs gauge="
                )
        else:
            raise ValueError(
                f"SLO {self.name!r}: unknown mode {self.mode!r}"
            )


def default_serve_slos(queue_wait_ms: float = 500.0
                       ) -> Tuple[SloSpec, ...]:
    """The stock serving objectives the engine evaluates when the SLO
    plane is on: admission availability (rejections burn the budget)
    and queue-wait latency (p50 beyond the bound burns it)."""
    return (
        SloSpec(name="serve_availability", target=0.99, mode="ratio",
                bad="rejected", total="submitted"),
        SloSpec(name="serve_queue_wait", target=0.9, mode="threshold",
                gauge="queue_wait_p50_ms", threshold=queue_wait_ms),
    )


def _alert_detail(spec: SloSpec, worst: dict) -> dict:
    """The ``slo_alert`` event's ``detail`` payload — the one place
    the wire shape is built."""
    return {
        "slo": spec.name,
        "mode": spec.mode,
        "target": spec.target,
        "burn_rate": worst["burn_rate"],
        "error_rate": worst["error_rate"],
        "fast_window_s": worst["fast_window_s"],
        "slow_window_s": worst["slow_window_s"],
        "threshold_burn": worst["threshold_burn"],
    }


class SloEvaluator:
    """Evaluates specs against a :class:`TimeSeriesStore` and emits
    deduplicated ``slo_alert`` events."""

    def __init__(self, store: TimeSeriesStore, specs,
                 clock: Optional[Callable[[], float]] = None,
                 emit: Optional[Callable[[dict], None]] = None):
        import time

        self.store = store
        self.specs: Tuple[SloSpec, ...] = tuple(specs)
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        self._clock = clock if clock is not None else time.time
        self._emit = emit
        self._firing: Dict[str, bool] = {s.name: False for s in self.specs}
        self._alerts_total: Dict[str, int] = \
            {s.name: 0 for s in self.specs}
        self._last: Dict[str, dict] = {}

    # -- the math ------------------------------------------------------------
    def _error_rate(self, spec: SloSpec,
                    window_s: float) -> Optional[float]:
        if spec.mode == "ratio":
            bad = self.store.rate(spec.bad, window_s)
            total = self.store.rate(spec.total, window_s)
            if bad is None or total is None or total <= 0:
                return None
            return min(max(bad / total, 0.0), 1.0)
        points = self.store.series(spec.gauge, window_s)
        if not points:
            return None
        over = sum(1 for _, v in points if v > spec.threshold)
        return over / len(points)

    def _burn(self, spec: SloSpec,
              window_s: float) -> Optional[float]:
        err = self._error_rate(spec, window_s)
        if err is None:
            return None
        return err / max(1.0 - spec.target, 1e-9)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self) -> List[dict]:
        """One evaluation pass: returns the NEW alerts (events already
        handed to ``emit``), updating the firing/re-arm state."""
        from ray_lightning_tpu_torch.telemetry.monitor import make_event

        alerts = []
        for spec in self.specs:
            worst = None  # the window pair burning hardest
            firing = False
            for fast_s, slow_s, bound in spec.windows:
                fast = self._burn(spec, fast_s)
                slow = self._burn(spec, slow_s)
                if fast is None or slow is None:
                    continue
                pair_firing = fast >= bound and slow >= bound
                burn = min(fast, slow)  # the pair burns at its floor
                if worst is None or burn > worst["burn_rate"]:
                    worst = {
                        "burn_rate": burn,
                        "fast_window_s": fast_s,
                        "slow_window_s": slow_s,
                        "threshold_burn": bound,
                        "error_rate": self._error_rate(spec, slow_s)
                        or 0.0,
                    }
                firing = firing or pair_firing
            self._last[spec.name] = {
                "firing": firing,
                "burn_rate": worst["burn_rate"] if worst else 0.0,
                "error_rate": worst["error_rate"] if worst else 0.0,
                "target": spec.target,
                "alerts_total": self._alerts_total[spec.name],
            }
            was = self._firing[spec.name]
            self._firing[spec.name] = firing
            if firing and not was and worst is not None:
                self._alerts_total[spec.name] += 1
                self._last[spec.name]["alerts_total"] = \
                    self._alerts_total[spec.name]
                alert = make_event(
                    "slo_alert", -1,
                    message=(
                        f"SLO {spec.name} burning "
                        f"{worst['burn_rate']:.1f}x budget "
                        f"(threshold {worst['threshold_burn']:.1f}x "
                        f"over {worst['fast_window_s']:.0f}s/"
                        f"{worst['slow_window_s']:.0f}s)"
                    ),
                    detail=_alert_detail(spec, worst),
                )
                if self._emit is not None:
                    self._emit(alert)
                alerts.append(alert)
        return alerts

    def snapshot(self) -> dict:
        """Per-SLO burn/firing state for the prom family and the live
        export (``rlt_slo_*``; rlt_top's capacity pane)."""
        return {name: dict(state) for name, state in self._last.items()}

    @property
    def alerts_total(self) -> int:
        return sum(self._alerts_total.values())
