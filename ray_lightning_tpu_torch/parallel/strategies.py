"""Execution strategies: :class:`LocalStrategy`, the in-process fit on one
device (``ray_lightning_tpu/parallel/strategies.py::LocalStrategy``, which
there builds a mesh over every local device; here it is one device until
the multi-GPU slice)."""

from __future__ import annotations

from typing import Any, Dict, List

from ray_lightning_tpu_torch.core.loop import FitConfig, run_fit
from ray_lightning_tpu_torch.device import resolve_device

__all__ = ["LocalStrategy"]


class LocalStrategy:
    """Run the fit in this process on ``device`` (``None`` means
    ``"cuda"``, and raises without a card; pass ``"cpu"`` for the plain
    PyTorch path).  ``telemetry`` is a later slice: anything but None or
    ``"off"`` raises."""

    def __init__(self, device=None, telemetry=None):
        if telemetry not in (None, "off"):
            raise NotImplementedError(
                "telemetry is not supported by the PyTorch port yet (a "
                "later slice); leave it None")
        self.device = resolve_device(device)

    def run(self, module, datamodule, config: FitConfig,
            callbacks: List) -> Dict[str, Any]:
        return run_fit(module, datamodule, config, callbacks, self.device)
