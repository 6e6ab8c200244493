"""Per-worker session context (``ray_lightning_tpu/session.py``, copied:
the port imports nothing of the JAX package).

Each worker process of a strategy holds a process-global session with its
``rank``, the driver's queue (``put_queue``: callbacks deep inside the fit
ship items or thunks to the driver, which runs the thunks in its own
context) and the number of workers.  The port's extra is the worker's
``device`` (one card a rank), where the JAX package keeps the host's
devices and its mesh.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

__all__ = [
    "TpuTrainingSession",
    "init_session",
    "get_session",
    "shutdown_session",
    "is_session_enabled",
    "get_actor_rank",
    "put_queue",
]


class TpuTrainingSession:
    """Worker-side context of one run on one worker process."""

    def __init__(self, rank: int, queue: Optional[Any] = None,
                 num_workers: int = 1, device: Optional[Any] = None,
                 mesh: Optional[Any] = None):
        self.rank = rank
        self.queue = queue
        self.num_workers = num_workers
        self.device = device
        self.mesh = mesh

    def put_queue(self, item: Any) -> None:
        """Ship ``item`` (a dict, or a picklable callable the driver runs)
        to the driver's result pump (``util.process_results``)."""
        if self.queue is None:
            raise ValueError(
                "No queue is attached to this session. A queue is created "
                "by the strategy for every remote stage.")
        self.queue.put(item)


_session_lock = threading.Lock()
_session: Optional[TpuTrainingSession] = None


def init_session(*args, **kwargs) -> TpuTrainingSession:
    """Install the process-global session."""
    global _session
    with _session_lock:
        if _session is not None:
            raise ValueError(
                "A TpuTrainingSession is already active in this process. "
                "Call shutdown_session() first.")
        _session = TpuTrainingSession(*args, **kwargs)
        return _session


def get_session() -> TpuTrainingSession:
    if _session is None:
        raise ValueError(
            "No TpuTrainingSession is active. init_session() is called by "
            "the strategy on each worker before the fit loop starts.")
    return _session


def is_session_enabled() -> bool:
    return _session is not None


def shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


def get_actor_rank() -> int:
    """Rank of the calling worker."""
    return get_session().rank


def put_queue(item: Any) -> None:
    get_session().put_queue(item)
