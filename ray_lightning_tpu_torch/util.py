"""The driver's result pump (``ray_lightning_tpu/util.py``, copied).

While the workers run a stage, the driver sits in :func:`process_results`:
it drains the queue (a callable item runs in the driver's context) and
polls the workers' futures, so that a worker's death or exception
surfaces at once instead of leaving its peers blocked in a collective.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

from ray_lightning_tpu_torch.cluster.queue import DriverQueue

__all__ = ["process_results"]


def _drain_queue(queue: Optional[DriverQueue]) -> None:
    """Run every callable item on the queue in the driver's context (a
    worker's thunk); any other item has no reader and is dropped."""
    if queue is None:
        return
    while not queue.empty():
        item = queue.get_nowait()
        if callable(item):
            item()


def process_results(futures: Sequence[Any],
                    queue: Optional[DriverQueue] = None,
                    poll_interval_s: float = 0.1) -> List[Any]:
    """Block until every future resolves, pumping the queue meanwhile.

    Raises the first worker exception as soon as it is seen (its peers may
    be blocked in a collective that will never finish), after one last
    drain of the queue."""
    futures = list(futures)
    while True:
        _drain_queue(queue)
        done = [f for f in futures if f.done()]
        for f in done:
            exc = f.exception()
            if exc is not None:
                _drain_queue(queue)
                raise exc
        if len(done) == len(futures):
            break
        time.sleep(poll_interval_s)
    _drain_queue(queue)
    return [f.result() for f in futures]
