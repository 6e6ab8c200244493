"""Registry of the ``RLT_*`` environment knobs the port reads
(``ray_lightning_tpu/parallel/env_bus.py``, limited to those).

``forward=True`` puts a knob on the strategies' worker bridge: a variable
set on the driver reaches every worker's environment before the worker
reads it.  The others are read where they are set (the driver, the
serving router or client, one process)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

__all__ = ["EnvKnob", "KNOBS", "forwarded_vars", "registered_names"]


class EnvKnob(NamedTuple):
    name: str
    #: Bridged into every spawned worker's environment?
    forward: bool
    #: Where the knob is read.
    doc: str


KNOBS: Tuple[EnvKnob, ...] = (
    # -- the gradient wire (parallel/grad_sync.py, worker-side) -----------
    EnvKnob("RLT_GRAD_COMM", True, "grad compression mode (int8_ef/full)"),
    EnvKnob("RLT_GRAD_BUCKET_MB", True, "all-reduce bucket size"),
    EnvKnob("RLT_GRAD_BLOCK", True, "int8 quantization block length"),
    EnvKnob("RLT_GRAD_DCN_ONLY", True, "compress only across processes"),
    EnvKnob("RLT_GRAD_OVERLAP", True,
            "backward-overlapped grad sync: trunk segment count G "
            "(0/empty = step-end sync; parallel/overlap.py)"),
    # -- the fit loop and its telemetry (worker-side) ---------------------
    EnvKnob("RLT_TELEMETRY", True, "telemetry tier: off/cheap"),
    EnvKnob("RLT_TELEMETRY_SAMPLE", True, "step-stats sampling period"),
    EnvKnob("RLT_TELEMETRY_PEAK", True, "device peak for MFU"),
    EnvKnob("RLT_MEGASTEP", True, "fused micro-steps per dispatch"),
    EnvKnob("RLT_UPDATE_SHARDING", True, "cross-replica sharded update"),
    # -- the pipeline plane's transfer lane (mpmd/transfer.py, worker-side)
    EnvKnob("RLT_MPMD_WIRE_DTYPE", True,
            "stage activation/grad wire dtype (f32/bf16/int8)"),
    # -- driver- and process-local knobs ----------------------------------
    EnvKnob("RLT_BACKEND", False, "cluster backend selector (driver)"),
    EnvKnob("RLT_ELASTIC_MIN_WORKERS", False, "governor floor (driver)"),
    EnvKnob("RLT_ELASTIC_GROW_AFTER_S", False, "grow-back arm (driver)"),
    EnvKnob("RLT_SEGMENT_MIN_BYTES", False, "shm threshold (per process)"),
    EnvKnob("RLT_HEADROOM_ROUTING", False,
            "router placement tie-break on headroom (router-local)"),
    EnvKnob("RLT_BROWNOUT", False, "router brownout ladder (router-local)"),
    EnvKnob("RLT_HEDGE", False, "client hedged resubmit (client-local)"),
    EnvKnob("RLT_RETRY_MAX", False, "client retry attempts (client-local)"),
    EnvKnob("RLT_RETRY_BACKOFF_S", False,
            "client retry backoff base (client-local)"),
)


def forwarded_vars() -> Tuple[str, ...]:
    """Names the strategies bridge into every worker's environment."""
    return tuple(k.name for k in KNOBS if k.forward)


def registered_names() -> Tuple[str, ...]:
    return tuple(k.name for k in KNOBS)
