"""Cluster backend and object store (``ray_lightning_tpu/cluster/
backend.py``, its local half).

:class:`LocalBackend` runs process actors on this host.  ``put``
serializes an object once (stdlib pickle, ``cluster/rpc.py``) into an
:class:`ObjectRef`; each worker's ``get`` unpickles its own copy.  A
payload of ``min_segment_bytes`` or more (default 1 MiB,
``RLT_SEGMENT_MIN_BYTES``) travels as a checksummed tmpfs segment
(``cluster/shm.py``) whose path crosses the sockets instead of its bytes.

The JAX package's ``RemoteBackend`` (node agents on other hosts) and
``RayBackend`` are not ported: asking for either raises, naming ROADMAP
Queue 1 item 6.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

from ray_lightning_tpu_torch.cluster import rpc
from ray_lightning_tpu_torch.cluster.actor import ProcessActor
from ray_lightning_tpu_torch.cluster.queue import DriverQueue

__all__ = ["ObjectRef", "ClusterBackend", "LocalBackend", "get_backend"]


class ObjectRef:
    """A serialized object, by value or by segment."""

    __slots__ = ("_payload", "_segment_path", "_nbytes")

    def __init__(self, payload: Optional[bytes] = None,
                 segment_path: Optional[str] = None, nbytes: int = 0):
        self._payload = payload
        self._segment_path = segment_path
        self._nbytes = len(payload) if payload is not None else nbytes

    @classmethod
    def from_object_via_store(cls, obj: Any, store,
                              min_segment_bytes: int) -> "ObjectRef":
        """Spill to a segment of ``store`` when the payload is at least
        ``min_segment_bytes`` (every reader shares the store's host)."""
        payload = rpc.dumps(obj)
        if len(payload) < min_segment_bytes:
            return cls(payload=payload)
        return cls(segment_path=store.put(payload), nbytes=len(payload))

    def get(self) -> Any:
        if self._segment_path is not None:
            from ray_lightning_tpu_torch.cluster.shm import SegmentStore

            return rpc.loads(SegmentStore.get(self._segment_path))
        return rpc.loads(self._payload)

    def release(self) -> None:
        """Unlink the backing segment now (idempotent); ``get`` is invalid
        afterwards."""
        if self._segment_path is not None:
            try:
                os.unlink(self._segment_path)
            except OSError:
                pass
            self._segment_path = None
        self._payload = None

    @property
    def nbytes(self) -> int:
        return self._nbytes


class ClusterBackend:
    """The interface every control-plane backend implements."""

    def create_actor(self, name: str, env: Optional[Dict[str, str]] = None,
                     num_cpus: float = 1,
                     resources: Optional[Dict[str, float]] = None):
        raise NotImplementedError

    def put(self, obj: Any) -> ObjectRef:
        raise NotImplementedError

    def create_queue(self) -> DriverQueue:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class LocalBackend(ClusterBackend):
    """Process actors on this host; ``put`` spills large payloads to
    shared-memory segments."""

    def __init__(self, min_segment_bytes: Optional[int] = None):
        from ray_lightning_tpu_torch.cluster.shm import SegmentStore

        self._actors: List[ProcessActor] = []
        self._store = SegmentStore()
        self.min_segment_bytes = (
            min_segment_bytes if min_segment_bytes is not None
            else int(os.environ.get("RLT_SEGMENT_MIN_BYTES", 1 << 20)))

    def create_actor(self, name: str, env: Optional[Dict[str, str]] = None,
                     num_cpus: float = 1,
                     resources: Optional[Dict[str, float]] = None
                     ) -> ProcessActor:
        actor = ProcessActor(name=name, env=env)
        self._actors.append(actor)
        return actor

    def put(self, obj: Any) -> ObjectRef:
        return ObjectRef.from_object_via_store(obj, self._store,
                                               self.min_segment_bytes)

    def create_queue(self) -> DriverQueue:
        return DriverQueue()

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                a.kill()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        self._actors.clear()
        self._store.unlink_all()


def get_backend(name: Union[str, ClusterBackend, None] = None
                ) -> ClusterBackend:
    """The control plane: a ``ClusterBackend`` instance as it is, else by
    name (explicit ``name``, then ``RLT_BACKEND``, then ``"local"``)."""
    if isinstance(name, ClusterBackend):
        return name
    name = name or os.environ.get("RLT_BACKEND", "local")
    if name == "local":
        return LocalBackend()
    if name in ("remote", "ray"):
        raise NotImplementedError(
            f"cluster backend {name!r} is not ported yet (ROADMAP Queue 1 "
            f"item 6, the host planes); the port runs its workers on this "
            f"host with backend 'local'")
    raise ValueError(
        f"Unknown cluster backend {name!r} (expected local|remote|ray)")
