"""The event shape of the live monitor, as in
``ray_lightning_tpu/telemetry/monitor.py``: only :func:`make_event`,
which the SLO evaluator builds its alerts with.  The run monitor itself
waits for a later slice."""

from __future__ import annotations

import time
from typing import Any, Dict

__all__ = ["make_event"]


def make_event(kind: str, rank: int, **fields: Any) -> Dict[str, Any]:
    """An event document (the JAX package's ``validate_event`` shape);
    rank -1 = fleet-wide."""
    return {"type": "event", "kind": kind, "rank": rank,
            "ts": time.time(), **fields}
