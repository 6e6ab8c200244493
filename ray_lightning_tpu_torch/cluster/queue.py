"""The acknowledged TCP queue of the serving plane, as in
``ray_lightning_tpu/cluster/queue.py``.

:class:`DriverQueue` is the server: an accept loop on a TCP socket whose
reader threads feed a thread-safe in-memory queue.  :class:`QueueHandle`
is its picklable client, a ``(host, port)`` pair that any process may
``put`` through.  Each frame carries ``(client_id, seq, item)``: the
server acks only once the item is enqueued, a retry after a lost ack
resends the same seq, and the server drops a seq it has already
enqueued, so every item lands exactly once.

The JAX package's chaos hook on ``put`` (``fault.inject.fire
("queue_put")``) waits for the port's fault plane.
"""

from __future__ import annotations

import queue as _pyqueue
import socket
import threading
import uuid
from typing import Any, Optional

from ray_lightning_tpu_torch.cluster import rpc

__all__ = ["DriverQueue", "QueueHandle"]

# The ack read never blocks forever while the handle lock is held: a
# timeout surfaces as an OSError into the close-and-retry path.
_ACK_TIMEOUT_S = 60.0
# Sends get a budget scaled by size (a socket timeout caps the whole
# sendall), assuming at worst ~1 MiB/s.
_MIN_SEND_THROUGHPUT = 1 << 20  # bytes/s
# Frames past this go in chunks, each with its own budget: progress per
# chunk is bounded, the total is not.
_SEND_CHUNK_BYTES = 8 << 20


def _send_timeout_s(payload_bytes: int) -> float:
    """The budget of each slow part of a ``put``: connect, each chunk,
    and the ack (sent once the whole frame is read and enqueued)."""
    return max(_ACK_TIMEOUT_S, payload_bytes / _MIN_SEND_THROUGHPUT)


def _sendall_chunked(sock: socket.socket, payload: bytes,
                     chunk_bytes: int = _SEND_CHUNK_BYTES) -> None:
    view = memoryview(payload)
    for off in range(0, len(view), chunk_bytes):
        chunk = view[off:off + chunk_bytes]
        sock.settimeout(_send_timeout_s(len(chunk)))
        sock.sendall(chunk)


class QueueHandle:
    """Picklable client of a :class:`DriverQueue`: one connection per
    process, opened at the first ``put``."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._client_id = uuid.uuid4().hex
        self._seq = 0

    # Pickling drops the socket; each unpickled copy is a new producer
    # with its own dedup identity.
    def __getstate__(self):
        return {"host": self.host, "port": self.port}

    def __setstate__(self, state):
        self.__init__(state["host"], state["port"])

    def _connect(self, timeout: float = 60.0) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def put(self, item: Any) -> None:
        """Ship ``item``; returns once the server has enqueued it.

        One reconnect on a failed send or a lost ack, with the same seq:
        the server drops a replay it already enqueued, so the item lands
        exactly once."""
        with self._lock:
            # The seq is spent even if both attempts fail: the server may
            # have committed it, and it must never name another item.
            self._seq += 1
            payload = rpc.dumps((self._client_id, self._seq, item))
            try:
                self._put_once(payload)
            except (OSError, ConnectionError):
                self.close()
                self._put_once(payload)

    def _put_once(self, payload: bytes) -> None:
        budget = _send_timeout_s(len(payload))
        sock = self._connect(timeout=budget)
        try:
            sock.settimeout(budget)
            sock.sendall(rpc.FRAME_HEADER.pack(len(payload)))
            _sendall_chunked(sock, payload)
            sock.settimeout(budget)
            ack = sock.recv(1)
        except Exception:
            # Half-sent frame or an ack in flight: the connection's ack
            # stream is no longer trustworthy.
            self.close()
            raise
        if ack != b"\x01":
            self.close()
            raise ConnectionError("queue server closed before ack")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class DriverQueue:
    """The queue's server: ``handle`` for producers, ``get`` /
    ``get_nowait`` for the consumer."""

    def __init__(self, host: str = "127.0.0.1",
                 advertise_host: Optional[str] = None):
        self._items: _pyqueue.Queue = _pyqueue.Queue()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, 0))
        self._server.listen(128)
        self._port = self._server.getsockname()[1]
        self._advertise_host = advertise_host or host
        self._closed = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # Per-producer high-water marks of the replay dedup.
        self._seen: dict = {}
        self._seen_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rlt-queue-accept", daemon=True
        )
        self._accept_thread.start()

    @property
    def handle(self) -> QueueHandle:
        return QueueHandle(self._advertise_host, self._port)

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._reader_loop, args=(conn,),
                             daemon=True).start()

    def _reader_loop(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                frame = rpc.recv_frame(conn)
                if self._closed.is_set():
                    # Shut down under the recv: no ack, so the producer's
                    # put raises instead of feeding a dead queue.
                    break
                try:
                    cid, seq, item = rpc.loads(frame)
                except Exception:
                    break  # a garbage frame drops its connection only
                with self._seen_lock:
                    fresh = seq > self._seen.get(cid, 0)
                    if fresh:
                        self._seen[cid] = seq
                if fresh:
                    self._items.put(item)
                # A replay is acked too: its ack was what got lost.
                conn.sendall(b"\x01")
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def empty(self) -> bool:
        return self._items.empty()

    def get_nowait(self) -> Any:
        return self._items.get_nowait()

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._items.get(timeout=timeout)

    def shutdown(self) -> None:
        self._closed.set()
        try:
            # shutdown wakes the accept loop, which a close alone does not
            # (its thread would outlive the queue).
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            pass
        # shutdown(SHUT_RDWR) wakes a reader blocked in recv, which a
        # close alone does not; its producer's next put then fails fast.
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
