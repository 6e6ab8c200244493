"""The wire frames of the disaggregated serving plane, as in
``ray_lightning_tpu/serve/dist/handoff.py``, field for field.

Every frame is a small typed dict.  A bulk payload rides either inline
(``data`` bytes, chunk-sent by ``cluster/queue.py``) or as a tmpfs
segment path (``shm``, same host, ``SegmentStore`` prefix ``rlt-kv``);
the consumer resolves either with ``mpmd/transfer.py::resolve_payload``
(read once, unlinked once).  Frame families (their envelopes are the JAX
package's ``telemetry/schema.py`` validators' shapes):

* ``serve_prefill_dispatch`` — router → prefill worker: the request and
  the inbox of the decode replica that will decode it;
* ``serve_kv_handoff`` — prefill worker → decode replica: the request,
  its bucket and the ``encode_kv_payload`` blob (the prompt's k/v blocks
  and its last position's logits);
* ``serve_adapter_load`` — router → member: one tenant's factors;
* ``serve_replica_hello`` / ``serve_replica_beat`` — member → router:
  the inbox and capabilities, then liveness, load and the terminal feed;
* ``serve_migration`` — draining replica → router → survivor: one
  resident sequence's k/v and position;
* ``serve_cancel`` — router → replica: drop a rid.

Host only: nothing here touches a device.
"""

from __future__ import annotations

import logging
import queue as _pyqueue
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

__all__ = [
    "KV_SEGMENT_PREFIX",
    "CachedSender",
    "MemberOutbox",
    "request_fields",
    "make_dispatch_item",
    "make_handoff_item",
    "make_adapter_load_item",
    "make_hello_item",
    "make_beat_item",
    "make_migration_item",
    "make_cancel_item",
    "encode_kv_payload",
    "decode_kv_payload",
]

log = logging.getLogger(__name__)

# The serving plane's handoff segments have their own family, so the
# teardown sweeps (engine stop, router failover) collect dead handoffs
# without touching an MPMD fit's "rlt-seg" frames.
KV_SEGMENT_PREFIX = "rlt-kv"


class CachedSender:
    """One persistent ``QueueHandle`` per destination address, dropped on
    a send failure so the next attempt reconnects: the send helper of the
    router's outboxes and of the prefill workers' handoffs."""

    def __init__(self):
        self._handles: Dict[Tuple[str, int], Any] = {}

    def put(self, addr, item: Dict[str, Any]) -> None:
        from ray_lightning_tpu_torch.cluster.queue import QueueHandle

        addr = (addr[0], int(addr[1]))
        handle = self._handles.get(addr)
        if handle is None:
            handle = QueueHandle(addr[0], addr[1])
            self._handles[addr] = handle
        try:
            handle.put(item)
        except BaseException:
            self._handles.pop(addr, None)
            raise

    def close(self) -> None:
        for handle in self._handles.values():
            handle.close()
        self._handles.clear()


class MemberOutbox:
    """A send thread with a bounded queue for one destination, so the
    router never blocks inside a TCP connect to a wedged member.  Sends
    enqueue in O(1) and the thread pays the network.  A send failure, or
    a full queue (a member that stopped reading ``maxsize`` frames ago),
    is reported once through ``on_error``, which the router maps to its
    death and failover path.  ``put``'s ``on_sent(enqueue_ts)`` runs once
    the frame is on the wire (the router's ``placement`` span)."""

    def __init__(self, addr: Tuple[str, int],
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 maxsize: int = 256):
        self.addr = (addr[0], int(addr[1]))
        self._on_error = on_error
        self._q: _pyqueue.Queue = _pyqueue.Queue(maxsize=maxsize)
        self._sender = CachedSender()
        self._closed = threading.Event()
        self._dead = False
        # The router reaps lanes idle past a threshold (client reply
        # lanes come and go).
        self.last_used = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"rlt-outbox-{self.addr[0]}:{self.addr[1]}",
        )
        self._thread.start()

    def put(self, item: Dict[str, Any],
            on_sent: Optional[Callable[[float], None]] = None) -> None:
        """Enqueue one frame.  Raises ``ConnectionError`` when the outbox
        is dead or full: the caller's send-failure path then runs."""
        if self._dead or self._closed.is_set():
            raise ConnectionError(f"outbox to {self.addr} is closed")
        self.last_used = time.monotonic()
        try:
            self._q.put_nowait((item, on_sent, time.monotonic()))
        except _pyqueue.Full:
            raise ConnectionError(
                f"outbox to {self.addr} is full ({self._q.maxsize} "
                f"frames undrained — member wedged?)"
            ) from None

    def _run(self) -> None:
        while not self._closed.is_set():
            try:
                item, on_sent, t_enq = self._q.get(timeout=0.2)
            except _pyqueue.Empty:
                continue
            try:
                try:
                    self._sender.put(self.addr, item)
                except Exception as e:  # noqa: BLE001 - any send failure
                    # marks the member; the router decides what it means
                    self._dead = True
                    if self._on_error is not None:
                        try:
                            self._on_error(e)
                        except Exception:  # noqa: BLE001 - observer bug
                            log.warning("outbox on_error raised",
                                        exc_info=True)
                    return
                if on_sent is not None:
                    try:
                        on_sent(t_enq)
                    except Exception:  # noqa: BLE001 - tracing must not
                        # kill the lane
                        log.warning("outbox on_sent raised", exc_info=True)
            finally:
                self._q.task_done()

    @property
    def depth(self) -> int:
        return self._q.qsize()

    @property
    def pending(self) -> int:
        """Frames enqueued and not yet sent or failed (the flush
        condition): a frame counts from ``put`` until its send returns,
        including while the thread holds it between the queue and the
        wire."""
        return self._q.unfinished_tasks

    def close(self, drain_s: float = 2.0) -> None:
        """Stop the thread after a best-effort drain of the queued frames.
        Safe from the outbox thread itself (the error callback), and
        never joins a dead box's thread: it may be blocked on the
        caller's own lock inside ``on_error`` and ends on its own once
        the callback returns."""
        deadline = time.monotonic() + drain_s
        while (not self._dead and self._q.qsize()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        self._closed.set()
        if (not self._dead
                and threading.current_thread() is not self._thread):
            self._thread.join(timeout=5)
        self._sender.close()


def request_fields(
    rid: str,
    prompt: Sequence[int],
    max_new_tokens: int,
    *,
    reply: Sequence,
    sample_seed: int,
    temperature: float = 0.0,
    eos_token_id: Optional[int] = None,
    top_k: Optional[int] = None,
    spec: Optional[int] = None,
    adapter: Optional[str] = None,
    deadline_s: Optional[float] = None,
    priority: int = 0,
    trace=None,
) -> Dict[str, Any]:
    """The request dict inside dispatch and handoff frames: a
    ``serve_request`` body with the router's fleet-wide ``sample_seed``
    (and, on a tracing router, the request's trace context).
    ``priority`` is the brownout shed class: 0 sheds first."""
    item = {
        "type": "serve_request",
        "rid": str(rid),
        "prompt": [int(t) for t in prompt],
        "max_new_tokens": int(max_new_tokens),
        "temperature": float(temperature),
        "eos_token_id": eos_token_id,
        "top_k": None if top_k is None else int(top_k),
        "spec": None if spec is None else int(spec),
        "adapter": None if adapter is None else str(adapter),
        "deadline_s": deadline_s,
        "sample_seed": int(sample_seed),
        "priority": int(priority),
        "reply": list(reply),
    }
    if trace is not None:
        from ray_lightning_tpu_torch.telemetry.propagate import inject

        inject(item, trace)
    return item


def make_dispatch_item(req: Dict[str, Any], kv_to: Tuple[str, int],
                       same_host: bool = False) -> Dict[str, Any]:
    """Router → prefill worker: prefill ``req``'s prompt and hand its k/v
    to the decode replica's inbox at ``kv_to``.  ``same_host`` allows the
    tmpfs payload form (the router sets it when the worker and the
    replica advertise one host); inline bytes work anywhere."""
    return {
        "type": "serve_prefill_dispatch",
        "rid": req["rid"],
        "req": dict(req),
        "kv_to": [kv_to[0], int(kv_to[1])],
        "same_host": bool(same_host),
    }


def make_handoff_item(
    req: Dict[str, Any],
    bucket: int,
    *,
    data: Optional[bytes] = None,
    shm: Optional[str] = None,
    trace=None,
) -> Dict[str, Any]:
    """Prefill worker → decode replica: the prefilled request.  Exactly
    one of ``data``/``shm`` carries the :func:`encode_kv_payload` blob.
    ``trace`` (the worker's span) stamps the send time the replica books
    ``handoff_transfer`` from."""
    if (data is None) == (shm is None):
        raise ValueError("exactly one of data/shm payload required")
    item: Dict[str, Any] = {
        "type": "serve_kv_handoff",
        "rid": req["rid"],
        "bucket": int(bucket),
        "prompt_len": len(req["prompt"]),
        "req": dict(req),
    }
    if data is not None:
        item["data"] = data
    else:
        item["shm"] = shm
    if trace is not None:
        from ray_lightning_tpu_torch.telemetry.propagate import inject

        inject(item, trace)
    return item


def make_adapter_load_item(
    name: str,
    rank: int,
    *,
    data: Optional[bytes] = None,
    shm: Optional[str] = None,
) -> Dict[str, Any]:
    """Router → member (decode replica or prefill worker): load one
    tenant's LoRA factors into the member's pool.  Exactly one of
    ``data``/``shm`` carries the ``serve/lora.py::encode_adapter``
    blob."""
    if (data is None) == (shm is None):
        raise ValueError("exactly one of data/shm payload required")
    item: Dict[str, Any] = {
        "type": "serve_adapter_load",
        "name": str(name),
        "rank": int(rank),
    }
    if data is not None:
        item["data"] = data
    else:
        item["shm"] = shm
    return item


def make_hello_item(role: str, member_id: str, inbox: Tuple[str, int],
                    **caps: Any) -> Dict[str, Any]:
    """A member's registration: its inbox and the capabilities placement
    reads (``num_slots``, ``max_queue``, ``spec_k``, ``max_prompt_len``,
    ...)."""
    return {
        "type": "serve_replica_hello",
        "role": role,
        "id": str(member_id),
        "inbox": [inbox[0], int(inbox[1])],
        **caps,
    }


def make_beat_item(
    role: str,
    member_id: str,
    *,
    done: Sequence[Tuple[str, str]] = (),
    failed: Sequence[Tuple[str, str]] = (),
    snapshot: Optional[Dict[str, Any]] = None,
    recompiles: Optional[int] = None,
    adapters: Optional[Sequence[str]] = None,
    closing: bool = False,
    migrating: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """A member's periodic beat.  ``done``: terminal ``(rid, status)``
    pairs since the last beat (the router prunes its in-flight set);
    ``failed``: ``(rid, error)`` pairs the member could not serve (the
    router re-routes them); ``adapters``: the tenants it holds;
    ``closing``: a planned drain, not a death; ``migrating``: rids whose
    live k/v export is under way (beat-loss failover waits for them)."""
    item: Dict[str, Any] = {
        "type": "serve_replica_beat",
        "role": role,
        "id": str(member_id),
        "ts": time.time(),
        "done": [[str(r), str(s)] for r, s in done],
        "failed": [[str(r), str(e)] for r, e in failed],
    }
    if snapshot is not None:
        item["snapshot"] = snapshot
    if recompiles is not None:
        item["recompiles"] = int(recompiles)
    if adapters is not None:
        item["adapters"] = [str(a) for a in adapters]
    if closing:
        item["closing"] = True
    if migrating is not None:
        item["migrating"] = [str(r) for r in migrating]
    return item


def make_migration_item(
    req: Dict[str, Any],
    *,
    generated: Sequence[int],
    cur_token: int,
    seq_len: int,
    data: bytes,
    trace=None,
) -> Dict[str, Any]:
    """Draining replica → router → survivor: one resident sequence.
    ``generated`` are the tokens already emitted, ``cur_token`` the last
    one (the next tick's input), ``seq_len`` the cache positions written
    (``prompt_len + len(generated) - 1``: the last token's k/v is written
    by its own tick), ``data`` the ``encode_tree({"kv": ...})`` blob of
    its ``ceil(seq_len / block_size)`` blocks.  Migration frames ride the
    ordered beat lane, so the payload is always inline."""
    item: Dict[str, Any] = {
        "type": "serve_migration",
        "rid": str(req["rid"]),
        "req": dict(req),
        "generated": [int(t) for t in generated],
        "cur_token": int(cur_token),
        "seq_len": int(seq_len),
        "data": data,
    }
    if trace is not None:
        from ray_lightning_tpu_torch.telemetry.propagate import inject

        inject(item, trace)
    return item


def make_cancel_item(rid: str) -> Dict[str, Any]:
    """Router → decode replica: drop ``rid`` wherever it is (the losing
    copy of a hedged pair).  The replica books it ``cancelled`` on its
    done feed."""
    return {"type": "serve_cancel", "rid": str(rid)}


def encode_kv_payload(kv: Dict[str, Any], logits: Any) -> bytes:
    """A prefill's exported blocks and last-position logits (host numpy
    or tensors), serialized: the handoff frame's payload."""
    from ray_lightning_tpu_torch.mpmd.transfer import encode_tree

    return encode_tree({"kv": kv, "logits": logits})


def decode_kv_payload(item: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`encode_kv_payload` over a handoff or migration
    frame (a ``shm`` segment is read once and unlinked)."""
    from ray_lightning_tpu_torch.mpmd.transfer import (
        decode_tree, resolve_payload,
    )

    return decode_tree(resolve_payload(item))
