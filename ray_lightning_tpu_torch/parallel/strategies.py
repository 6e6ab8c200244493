"""Execution strategies: :class:`LocalStrategy`, the in-process fit on one
device (``ray_lightning_tpu/parallel/strategies.py::LocalStrategy``, which
there builds a mesh over every local device; here it is one device until
the multi-GPU slice)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.core.loop import (
    FitConfig, _normalize_megastep, run_eval, run_fit, run_predict,
)
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.telemetry.runtime import TelemetryConfig

__all__ = ["LocalStrategy"]


class LocalStrategy:
    """Run the fit in this process on ``device`` (``None`` means
    ``"cuda"``, and raises without a card; pass ``"cpu"`` for the plain
    PyTorch path).

    ``telemetry``: ``None`` (the ``RLT_TELEMETRY`` variable, else the
    cheap tier), ``"cheap"``, ``"off"``, a dict with ``tier`` and
    ``sample_every``, or a ``TelemetryConfig``; ``"full"`` raises (a later
    slice).  ``megastep``: K micro-steps a dispatch (``"auto"``, ``"off"``
    or an int); it fills the Trainer's when that is unset."""

    def __init__(self, device=None, telemetry=None, megastep=None):
        if telemetry is not None:
            telemetry = TelemetryConfig.coerce(telemetry)
        self.telemetry = telemetry
        _normalize_megastep(megastep)
        self.megastep = megastep
        self.device = resolve_device(device)

    def run(self, kind: str, module, datamodule, config: FitConfig,
            callbacks: List, params=None,
            ckpt_path: Optional[str] = None) -> Dict[str, Any]:
        """Run stage ``kind`` ("fit", "validation", "test" or "predict")
        here; the eval stages take ``params`` (a fitted state's, handed
        over as they are) or ``ckpt_path``."""
        if config.megastep is None and self.megastep is not None:
            config = dataclasses.replace(config, megastep=self.megastep)
        if kind == "fit":
            return run_fit(module, datamodule, config, callbacks,
                           self.device, telemetry=self.telemetry)
        if kind in ("validation", "test"):
            return run_eval(module, datamodule, config, callbacks,
                            self.device, kind, params, ckpt_path)
        if kind == "predict":
            return run_predict(module, datamodule, config, self.device,
                               params, ckpt_path)
        raise ValueError(f"unknown stage {kind!r}: expected 'fit', "
                         f"'validation', 'test' or 'predict'")
