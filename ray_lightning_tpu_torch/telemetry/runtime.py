"""Telemetry runtime: config coercion and the per-fit Telemetry object (a
copy of ``ray_lightning_tpu/telemetry/runtime.py`` for the cheap tier).

Tiers (``TelemetryConfig.tier``):

* ``off``: nothing recorded, no metric keys;
* ``cheap``: **the default**: counters, step stats and the headline
  metrics in ``callback_metrics``;
* ``full``: spans and trace exports, a later slice of the port: asking
  for it raises.

Config sources, strongest first: an explicit ``telemetry=`` on the
strategy → the ``RLT_TELEMETRY`` environment variable (tier name), with
``RLT_TELEMETRY_SAMPLE`` refining the sampling cadence → the cheap
default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from .step_stats import StepStats

__all__ = ["TelemetryConfig", "Telemetry", "TIERS"]

TIERS = ("off", "cheap", "full")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """User-facing telemetry knobs.  ``sample_every`` is the cadence of
    the steps whose wall time waits for the device (``StepStats``)."""

    tier: str = "cheap"
    sample_every: int = 32

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(
                f"telemetry tier {self.tier!r}: expected one of {TIERS}"
            )
        if self.tier == "full":
            raise NotImplementedError(
                "telemetry tier 'full' (spans and trace exports) is not "
                "supported by the PyTorch port yet (the spans slice); use "
                "'cheap' or 'off'")
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1")

    @classmethod
    def coerce(cls, value: Any) -> "TelemetryConfig":
        """None | str | dict | TelemetryConfig → TelemetryConfig.
        ``None`` reads ``RLT_TELEMETRY`` (tier name); ``RLT_TELEMETRY_SAMPLE``
        sets ``sample_every`` where the value does not."""
        if isinstance(value, cls):
            return value
        if value is None:
            value = os.environ.get("RLT_TELEMETRY") or "cheap"
        if isinstance(value, str):
            kw: dict = {"tier": value}
        elif isinstance(value, dict):
            kw = dict(value)
            kw.setdefault("tier", "cheap")
            unknown = set(kw) - {"tier", "sample_every"}
            if unknown:
                raise NotImplementedError(
                    f"telemetry options {sorted(unknown)} are not "
                    f"supported by the PyTorch port yet (its cheap tier "
                    f"takes 'tier' and 'sample_every')")
        else:
            raise TypeError(
                "telemetry must be a tier string, dict or TelemetryConfig; "
                f"got {type(value).__name__}"
            )
        env_sample = os.environ.get("RLT_TELEMETRY_SAMPLE")
        if env_sample and "sample_every" not in kw:
            kw["sample_every"] = int(env_sample)
        return cls(**kw)


class Telemetry:
    """Per-fit telemetry state: the step stats, counters and meta."""

    def __init__(self, config: TelemetryConfig):
        self.config = config
        self.enabled = config.tier != "off"
        self.step_stats: Optional[StepStats] = (
            StepStats(sample_every=config.sample_every)
            if self.enabled else None
        )
        self.counters: Dict[str, float] = {}
        self.meta: Dict[str, Any] = {}

    @classmethod
    def build(cls, value: Any) -> "Telemetry":
        return cls(TelemetryConfig.coerce(value))

    def add_counter(self, name: str, value: float) -> None:
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + value

    def set_meta(self, name: str, value: Any) -> None:
        if self.enabled:
            self.meta[name] = value

    def headline_metrics(self) -> Dict[str, float]:
        """The numbers a plain ``fit()`` folds into callback_metrics."""
        if self.step_stats is None:
            return {}
        return self.step_stats.headline()

    def report(self) -> Dict[str, Any]:
        """``Trainer.telemetry_report``: empty when the tier is off."""
        if not self.enabled:
            return {}
        return {
            "tier": self.config.tier,
            "step_stats": self.step_stats.summary(),
            "counters": dict(self.counters),
            "meta": dict(self.meta),
        }
