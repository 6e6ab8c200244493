"""Process actors: the worker launch of the port's control plane
(``ray_lightning_tpu/cluster/actor.py``, copied without its fault hooks).

An actor is a fresh ``subprocess`` running this module's
:func:`_child_main` (never a ``fork``: a process that has touched CUDA
cannot fork a child that uses it), so the user's ``__main__`` is never
re-imported.  Calls travel as stdlib-pickle frames (``cluster/rpc.py``)
over a loopback TCP connection, authenticated by a random key passed
through the child's stdin.  Functions and classes therefore travel by
reference: a callable shipped to an actor must be importable there, and
:func:`build_child_env` puts the spawner's ``sys.path`` on the child's.

Two lanes share the connection: ``call`` runs user functions one after
another on a worker thread; ``ctl`` (``ping``, ``dump_stacks``) is
answered on the receive thread, so it answers while a call is stuck in
a collective.  The JAX package's flight recorder, heartbeats, drain and
chaos hooks are a later slice of the port (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import itertools
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

from ray_lightning_tpu_torch.cluster import rpc

__all__ = ["ProcessActor", "RemoteError", "ActorDiedError",
           "build_child_env", "spawn_child"]


class RemoteError(RuntimeError):
    """An exception raised inside an actor, re-raised on the driver with
    the actor's formatted traceback."""

    def __init__(self, actor_name: str, formatted_traceback: str):
        super().__init__(
            f"Remote call on actor {actor_name!r} failed:\n"
            f"{formatted_traceback}")
        self.actor_name = actor_name
        self.remote_traceback = formatted_traceback


class ActorDiedError(RuntimeError):
    """The actor process exited before answering.  ``exit_code``,
    ``rank`` and ``actor_name`` say which and how, where known;
    :meth:`enrich` fills the rest and folds it into the message."""

    def __init__(self, message: str, *, actor_name=None, exit_code=None,
                 rank=None):
        super().__init__(message)
        self.actor_name = actor_name
        self.exit_code = exit_code
        self.rank = rank

    def enrich(self, **fields) -> "ActorDiedError":
        notes = []
        for key in ("actor_name", "exit_code", "rank"):
            if key in fields and getattr(self, key) is None:
                setattr(self, key, fields[key])
        if self.rank is not None:
            notes.append(f"rank={self.rank}")
        if self.exit_code is not None:
            notes.append(f"exit_code={self.exit_code}")
        extra = fields.get("note")
        if notes or extra:
            detail = "; ".join(notes + ([extra] if extra else []))
            self.args = (f"{self.args[0]} [{detail}]",) + self.args[1:]
        return self


# ---------------------------------------------------------------------------
# Functions shipped to actors (top level, so they pickle by reference)
# ---------------------------------------------------------------------------

def _remote_set_env_vars(env: Dict[str, str]) -> None:
    for k, v in env.items():
        os.environ[k] = str(v)


def _remote_get_device_info() -> Dict[str, Any]:
    """The actor's device inventory (the JAX package's
    ``_remote_get_device_info``): its cards, as PyTorch reports them."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "pid": os.getpid(),
        "local_device_count": count,
        "platform": "gpu" if count else "cpu",
        "device_kinds": [torch.cuda.get_device_name(i)
                         for i in range(count)],
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    }


def _remote_dump_stacks() -> Dict[str, Any]:
    """Python stacks of every thread of the actor (control lane: answers
    while a call is wedged)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {
        f"{names.get(ident, '?')} ({ident})":
            "".join(traceback.format_stack(frame))
        for ident, frame in frames.items()
    }
    return {"pid": os.getpid(), "ts": time.time(), "stacks": stacks}


_CONTROL_HANDLERS: Dict[str, Callable[..., Any]] = {
    "dump_stacks": _remote_dump_stacks,
    "ping": lambda: {"pid": os.getpid(), "ts": time.time()},
}


# ---------------------------------------------------------------------------
# Child side
# ---------------------------------------------------------------------------

def _child_main() -> None:
    """Entry of the actor subprocess: dial the driver, authenticate, then
    serve the ``call`` and ``ctl`` lanes until ``exit``."""
    host, port = sys.argv[1], int(sys.argv[2])
    authkey = bytes.fromhex(sys.stdin.readline().strip())
    sock = socket.create_connection((host, port), timeout=60)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    rpc.send_frame(sock, authkey)
    send_lock = threading.Lock()

    def reply(obj: Any) -> None:
        with send_lock:
            rpc.send_frame(sock, rpc.dumps(obj))

    import queue as _pyqueue

    calls: "_pyqueue.Queue" = _pyqueue.Queue()

    def call_worker() -> None:
        while True:
            msg = calls.get()
            if msg is None:
                return
            _, call_id, payload = msg
            try:
                fn, args, kwargs = payload
                out = ("ok", call_id, fn(*args, **kwargs))
            except BaseException:  # noqa: BLE001 - ship it all back
                out = ("err", call_id, traceback.format_exc())
            try:
                reply(out)
            except (ConnectionError, OSError):
                return
            except BaseException:
                # The result does not pickle: say so instead of dying.
                reply(("err", call_id,
                       "actor result failed to serialize:\n"
                       + traceback.format_exc()))

    threading.Thread(target=call_worker, name="rlt-actor-calls",
                     daemon=True).start()
    while True:
        try:
            msg = rpc.loads(rpc.recv_frame(sock))
        except (ConnectionError, OSError):
            break
        kind = msg[0]
        if kind == "exit":
            reply(("bye", None, None))
            break
        if kind == "call":
            calls.put(msg)
        elif kind == "ctl":
            _, call_id, (op, kw) = msg
            handler = _CONTROL_HANDLERS.get(op)
            try:
                if handler is None:
                    raise ValueError(f"unknown control op {op!r}")
                out = ("ok", call_id, handler(**kw))
            except BaseException:  # noqa: BLE001
                out = ("err", call_id, traceback.format_exc())
            try:
                reply(out)
            except (ConnectionError, OSError):
                break
    sock.close()
    # The call thread is a daemon, and the exit must not wait for it
    # either: it may be wedged in a collective whose peer died.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def build_child_env(env: Dict[str, str]) -> Dict[str, str]:
    """The child's environment: this process's, the overrides, and this
    process's ``sys.path`` on ``PYTHONPATH`` (so whatever the driver
    imports by reference, the child can import too; '' becomes the
    working directory)."""
    child_env = dict(os.environ)
    child_env.update({k: str(v) for k, v in env.items()})
    spawner_path = [p if p else os.getcwd() for p in sys.path]
    pp = child_env.get("PYTHONPATH", "")
    extra = [p for p in pp.split(os.pathsep) if p and p not in spawner_path]
    child_env["PYTHONPATH"] = os.pathsep.join(spawner_path + extra)
    return child_env


def spawn_child(connect_host: str, port: int, authkey_hex: str,
                env: Dict[str, str]) -> subprocess.Popen:
    """Start one actor child that dials ``connect_host:port`` and
    authenticates with ``authkey_hex`` (fed through stdin, never argv)."""
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from ray_lightning_tpu_torch.cluster.actor import _child_main; "
         "_child_main()", connect_host, str(port)],
        stdin=subprocess.PIPE, env=build_child_env(env))
    assert proc.stdin is not None
    proc.stdin.write(authkey_hex.encode() + b"\n")
    proc.stdin.flush()
    return proc


class ProcessActor:
    """A worker subprocess with a generic ``submit``/``execute`` RPC."""

    _ids = itertools.count()

    def __init__(self, name: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 startup_timeout_s: float = 120.0):
        self.name = name or f"rlt-actor-{next(self._ids)}"
        self._env = dict(env or {})
        authkey = os.urandom(16)
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind(("127.0.0.1", 0))
        server.listen(1)
        host, port = server.getsockname()
        try:
            self._proc = spawn_child(host, port, authkey.hex(), self._env)
        except BaseException:
            server.close()
            raise
        # Accept with a timeout while polling the child: a child that dies
        # during startup is an ActorDiedError, never a hang.
        server.settimeout(1.0)
        conn: Optional[socket.socket] = None
        deadline = time.monotonic() + startup_timeout_s
        while conn is None:
            if self._proc.poll() is not None:
                server.close()
                raise ActorDiedError(
                    f"Actor {self.name!r} exited during startup (exit code "
                    f"{self._proc.returncode}).", actor_name=self.name,
                    exit_code=self._proc.returncode)
            if time.monotonic() > deadline:
                server.close()
                self._proc.kill()
                raise ActorDiedError(
                    f"Actor {self.name!r} did not connect within "
                    f"{startup_timeout_s}s.", actor_name=self.name)
            try:
                conn, _ = server.accept()
            except socket.timeout:
                continue
        server.close()
        conn.settimeout(None)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if rpc.recv_frame(conn) != authkey:
            conn.close()
            self._proc.kill()
            raise ActorDiedError(f"Actor {self.name!r} failed "
                                 f"authentication.", actor_name=self.name)
        self._conn = conn
        self._send_lock = threading.Lock()
        self._call_ids = itertools.count()
        self._pending: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._conn_dead = False
        self._recv_thread = threading.Thread(
            target=self._receive_loop, name=f"{self.name}-recv",
            daemon=True)
        self._recv_thread.start()

    # -- receive path -------------------------------------------------------
    def _receive_loop(self) -> None:
        while True:
            try:
                msg = rpc.loads(rpc.recv_frame(self._conn))
            except (ConnectionError, OSError):
                self._fail_all_pending()
                return
            status, call_id, payload = msg
            if status == "bye":
                self._fail_all_pending()
                return
            with self._lock:
                fut = self._pending.pop(call_id, None)
            if fut is None:
                continue
            if status == "ok":
                fut.set_result(payload)
            else:
                fut.set_exception(RemoteError(self.name, payload))

    def _fail_all_pending(self) -> None:
        with self._lock:
            self._conn_dead = True
            pending, self._pending = self._pending, {}
        # The connection drops a moment before the process is reaped.
        try:
            exit_code = self._proc.wait(timeout=1.0)
        except subprocess.TimeoutExpired:
            exit_code = None
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(ActorDiedError(
                    f"Actor {self.name!r} died before answering (exit code "
                    f"{exit_code}).", actor_name=self.name,
                    exit_code=exit_code))

    # -- submit path --------------------------------------------------------
    def _submit_msg(self, lane: str, payload: Any, what: str) -> Future:
        if self._closed or self._conn_dead or self._proc.poll() is not None:
            raise ActorDiedError(f"Actor {self.name!r} is not alive.",
                                 actor_name=self.name,
                                 exit_code=self._proc.poll())
        fut: Future = Future()
        call_id = next(self._call_ids)
        with self._lock:
            self._pending[call_id] = fut
        try:
            with self._send_lock:
                rpc.send_frame(self._conn,
                               rpc.dumps((lane, call_id, payload)))
        except (OSError, ValueError) as e:
            with self._lock:
                self._pending.pop(call_id, None)
            raise ActorDiedError(
                f"Failed to submit {what} to actor {self.name!r}: {e}",
                actor_name=self.name, exit_code=self._proc.poll())
        # The connection may have died between the check and the insert:
        # the receive loop's sweep could have missed this future.
        with self._lock:
            if self._conn_dead and not fut.done():
                self._pending.pop(call_id, None)
                fut.set_exception(ActorDiedError(
                    f"Actor {self.name!r} died during submit.",
                    actor_name=self.name, exit_code=self._proc.poll()))
        return fut

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Future:
        """Run ``fn(*args, **kwargs)`` in the actor; a ``Future``."""
        return self._submit_msg("call", (fn, args, kwargs), "call")

    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        return self.submit(fn, *args, **kwargs).result()

    def control(self, op: str, timeout: Optional[float] = 10.0,
                **kwargs: Any) -> Any:
        """An out-of-band request (``ping``, ``dump_stacks``), answered
        even while a call is running."""
        return self._submit_msg("ctl", (op, kwargs), f"ctl:{op}").result(
            timeout)

    def dump_stacks(self, timeout: Optional[float] = 10.0) -> Dict[str, Any]:
        return self.control("dump_stacks", timeout=timeout)

    # -- conveniences -------------------------------------------------------
    def set_env_vars(self, env: Dict[str, str]) -> None:
        self._env.update(env)
        self.execute(_remote_set_env_vars, env)

    def get_device_info(self) -> Dict[str, Any]:
        return self.execute(_remote_get_device_info)

    # -- lifecycle ----------------------------------------------------------
    def is_alive(self) -> bool:
        return (not self._closed and not self._conn_dead
                and self._proc.poll() is None)

    @property
    def exit_code(self) -> Optional[int]:
        return self._proc.poll()

    def kill(self, timeout: float = 5.0) -> None:
        """Ask the child to exit, then terminate and kill it if it has
        not within ``timeout``."""
        if self._closed:
            return
        self._closed = True
        try:
            with self._send_lock:
                rpc.send_frame(self._conn, rpc.dumps(("exit",)))
        except (OSError, ValueError):
            pass
        deadline = time.monotonic() + timeout
        while self._proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        try:
            self._conn.close()
        except OSError:
            pass
        try:
            from ray_lightning_tpu_torch.cluster.shm import (
                ALL_PREFIXES, sweep_stale_segments,
            )

            sweep_stale_segments(ALL_PREFIXES)
        except Exception:  # noqa: BLE001 - janitorial, never raises out
            pass


if __name__ == "__main__":
    _child_main()
