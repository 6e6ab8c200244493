"""Request submission and token streaming over the queue plane, as in
``ray_lightning_tpu/serve/client.py``.  Host only: it touches no device.

Every message is a small dict with a ``type`` tag (the JAX package's
``validate_serve_request`` / ``validate_serve_reply`` shapes) over the
acknowledged queue of ``cluster/queue.py`` in both directions: requests
into the engine's inbox (:meth:`ServeEngine.queue_handle`), replies (a
``serve_token`` per token, then ``serve_done``) into a reply queue the
client owns, whose ``(host, port)`` rides each request.  One engine
serves any number of clients, and a client of either package talks to an
engine of either package.

A full admission queue comes back as ``serve_done(status="rejected")``
and surfaces as :class:`ServeRejected`.  After a preemption the engine
re-streams a request's tokens from index 0; the client dedups on the
index, so a consumer sees each index once.  :class:`RetryPolicy` gives
:meth:`ServeClient.generate` a wall-clock budget, retries of the typed
retryable outcomes (``rejected``/``expired``/``shed``/``cancelled``) with
jittered exponential backoff, and optional hedged resubmission.
"""

from __future__ import annotations

import os
import queue as _pyqueue
import random
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

from ray_lightning_tpu_torch.cluster.queue import DriverQueue, QueueHandle
from ray_lightning_tpu_torch.serve.engine import ServeRejected

__all__ = ["RetryPolicy", "ServeClient", "ServeRejected"]


@dataclass
class RetryPolicy:
    """Knobs for :meth:`ServeClient.generate` resilience.

    ``max_attempts`` counts submissions (1 = no retry).  Backoff before
    attempt ``n`` is ``min(backoff_max_s, backoff_s * 2**(n-1))`` with
    full jitter (a uniform draw up to the computed value — retry storms
    from many clients must decorrelate).  ``budget_s`` is the
    per-request wall-clock budget across ALL attempts and backoffs
    (None = the call's ``timeout`` governs alone).  ``hedge`` enables
    hedged resubmission; ``hedge_after_s`` fixes the trigger delay, or
    None to adapt it to the client's observed p99 completion latency
    (no hedging until ``_HEDGE_MIN_SAMPLES`` completions are seen)."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_max_s: float = 2.0
    budget_s: Optional[float] = None
    hedge: bool = False
    hedge_after_s: Optional[float] = None

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """The policy the environment sets: ``RLT_RETRY_MAX``,
        ``RLT_RETRY_BACKOFF_S``, ``RLT_HEDGE`` (the JAX package's
        names)."""
        return cls(
            max_attempts=int(os.environ.get("RLT_RETRY_MAX", "3")),
            backoff_s=float(os.environ.get("RLT_RETRY_BACKOFF_S",
                                           "0.05")),
            hedge=os.environ.get("RLT_HEDGE", "0") == "1",
        )


class _Pending:
    """Client-side state for one in-flight request."""

    def __init__(self, rid: str):
        self.rid = rid
        self.tokens: List[int] = []
        self.stream: _pyqueue.Queue = _pyqueue.Queue()
        self.done = threading.Event()
        self.status: Optional[str] = None
        self.reason: Optional[str] = None
        self.error: Optional[str] = None
        self.item: Optional[dict] = None  # the wire item, for hedging
        self.hedged = False


class ServeClient:
    """One consumer of a serving engine.

    Thread-safe: many threads may ``generate``/``stream`` concurrently
    through one client; replies are demuxed by request id on a single
    reader thread.
    """

    _HEDGE_MIN_SAMPLES = 20

    def __init__(self, handle: QueueHandle,
                 retry: Optional[RetryPolicy] = None):
        self._inbox = handle
        self._replies = DriverQueue()
        self._reply_addr = (self._replies.handle.host,
                            self._replies.handle.port)
        self._pending: Dict[str, _Pending] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()
        # Tokens whose index had already streamed (preemption, router
        # failover, or hedged-duplicate re-emissions, deduped below) —
        # counted here.
        self.re_emitted_tokens = 0
        # Resilience accounting + the p99 estimate hedging adapts to.
        self.retry = retry if retry is not None else RetryPolicy.from_env()
        self.retries = 0
        self.hedges = 0
        self._latencies: deque = deque(maxlen=256)  # guarded by _lock
        self._reader = threading.Thread(
            target=self._read_loop, name="rlt-serve-client", daemon=True
        )
        self._reader.start()

    # -- submission ----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               top_k: Optional[int] = None,
               spec: Optional[int] = None,
               adapter: Optional[str] = None,
               deadline_s: Optional[float] = None,
               priority: int = 0) -> str:
        """Ship one request; returns its id immediately (streaming and
        completion arrive asynchronously).  ``spec`` caps the engine's
        speculative draft count for this request (0 = plain decode);
        tokens stream back in variable-width bursts either way, deduped
        by index like any re-emission.  ``adapter`` names the LoRA
        tenant to decode through (multi-tenant serving; a router
        places the request on — or hot-loads — a member holding it).
        ``priority`` is the brownout shed class: 0 sheds first under
        fleet overload, >= 1 survives to the shed rung."""
        rid = uuid.uuid4().hex[:12]
        pend = _Pending(rid)
        item = {
            "type": "serve_request",
            "rid": rid,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "eos_token_id": eos_token_id,
            "top_k": None if top_k is None else int(top_k),
            "spec": None if spec is None else int(spec),
            "adapter": None if adapter is None else str(adapter),
            "deadline_s": deadline_s,
            "priority": int(priority),
            "reply": list(self._reply_addr),
        }
        pend.item = item
        with self._lock:
            self._pending[rid] = pend
        self._inbox.put(item)
        return rid

    def hedge(self, rid: str) -> bool:
        """Resubmit an in-flight request's rid with the ``hedge``
        marker — a routed fleet places a duplicate on a second replica
        (same fleet-wide seed: identical tokens, merged by the index
        dedup); a single engine ignores the duplicate rid.  At most one
        hedge per request; returns whether one was sent."""
        pend = self._pending.get(rid)
        if pend is None or pend.item is None or pend.hedged \
                or pend.done.is_set():
            return False
        pend.hedged = True
        self._inbox.put(dict(pend.item, hedge=True))
        self.hedges += 1
        return True

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 timeout: Optional[float] = 60.0,
                 retry: Optional[RetryPolicy] = None, **kw) -> List[int]:
        """Blocking round trip → the generated tokens, with the
        client's :class:`RetryPolicy` applied: retryable outcomes
        (``rejected``/``expired``/``shed``/``cancelled``) back off with
        jitter and resubmit under a fresh rid, hedging (enabled)
        duplicates a straggling attempt after the trigger delay, and
        ``budget_s`` bounds the whole affair in wall-clock terms."""
        policy = retry if retry is not None else self.retry
        deadline = None if policy.budget_s is None \
            else time.monotonic() + policy.budget_s

        def remaining(default: Optional[float]) -> Optional[float]:
            if deadline is None:
                return default
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"request budget ({policy.budget_s}s) exhausted"
                )
            return left if default is None else min(default, left)

        last: Optional[ServeRejected] = None
        for attempt in range(max(1, policy.max_attempts)):
            if attempt:
                self.retries += 1
                pause = min(policy.backoff_max_s,
                            policy.backoff_s * (2 ** (attempt - 1)))
                # Full jitter: many clients retrying the same typed
                # rejection must not resubmit in lockstep.
                time.sleep(random.uniform(0.0,
                                          remaining(pause) or pause))
            t_submit = time.monotonic()
            rid = self.submit(prompt, max_new_tokens, **kw)
            pend = self._pending[rid]
            hedge_after = self._hedge_delay(policy)
            wait = remaining(timeout)
            if hedge_after is not None and not pend.done.is_set() \
                    and (wait is None or hedge_after < wait):
                if not pend.done.wait(hedge_after):
                    self.hedge(rid)
                if wait is not None:
                    wait = max(0.0, wait - hedge_after)
            try:
                tokens = self.result(rid, timeout=wait)
            except ServeRejected as e:
                last = e
                continue
            with self._lock:
                self._latencies.append(time.monotonic() - t_submit)
            return tokens
        assert last is not None
        raise last

    def _hedge_delay(self,
                     policy: RetryPolicy) -> Optional[float]:
        """The hedge trigger delay: the fixed knob when set, else the
        client's observed p99 completion latency (None — no hedge —
        until enough completions are banked to estimate one)."""
        if not policy.hedge:
            return None
        if policy.hedge_after_s is not None:
            return policy.hedge_after_s
        with self._lock:
            if len(self._latencies) < self._HEDGE_MIN_SAMPLES:
                return None
            ordered = sorted(self._latencies)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * len(ordered)))]

    def stream(self, prompt: Sequence[int], max_new_tokens: int,
               timeout: Optional[float] = 60.0, **kw) -> Iterator[int]:
        """Submit and yield tokens as the engine emits them (indices
        deduped across preemptions)."""
        rid = self.submit(prompt, max_new_tokens, **kw)
        pend = self._pending[rid]
        next_idx = 0
        while True:
            try:
                kind, payload = pend.stream.get(timeout=timeout)
            except _pyqueue.Empty:
                raise TimeoutError(
                    f"request {rid}: no stream item within {timeout}s"
                ) from None
            if kind == "token":
                idx, tok = payload
                if idx == next_idx:  # dedup re-emissions after preempt
                    next_idx += 1
                    yield tok
            else:  # done
                self._check_done(pend)
                return

    def result(self, rid: str, timeout: Optional[float] = 60.0
               ) -> List[int]:
        pend = self._pending.get(rid)
        if pend is None:
            raise KeyError(f"unknown request id {rid}")
        if not pend.done.wait(timeout):
            raise TimeoutError(f"request {rid} not finished in {timeout}s")
        self._check_done(pend)
        return list(pend.tokens)

    def _check_done(self, pend: _Pending) -> None:
        with self._lock:
            self._pending.pop(pend.rid, None)
        if pend.status == "invalid":
            raise ValueError(
                f"request {pend.rid} invalid: {pend.error}"
            )
        if pend.status == "error":
            raise RuntimeError(
                f"serve engine died with request {pend.rid} in flight: "
                f"{pend.error}"
            )
        if pend.status in ("shed", "cancelled") \
                or pend.reason in ("rejected", "expired"):
            # All four are RETRYABLE: the fleet declined or dropped the
            # work without partial side effects a retry would duplicate
            # ("shed" is the brownout ladder's overload reply,
            # "cancelled" an operator/hedge-path drop).
            raise ServeRejected(
                f"request {pend.rid} "
                f"{pend.reason or pend.status}"
            )

    # -- reply demux ---------------------------------------------------------
    def _read_loop(self) -> None:
        while not self._closed.is_set():
            try:
                item = self._replies.get(timeout=0.5)
            except _pyqueue.Empty:
                continue
            except (OSError, ValueError):
                return  # queue shut down
            if not isinstance(item, dict):
                continue
            pend = self._pending.get(str(item.get("rid")))
            if pend is None:
                continue
            kind = item.get("type")
            if kind == "serve_token":
                idx, tok = int(item["index"]), int(item["token"])
                if idx == len(pend.tokens):
                    pend.tokens.append(tok)
                elif idx < len(pend.tokens):
                    pend.tokens[idx] = tok  # preemption re-emission
                    self.re_emitted_tokens += 1
                pend.stream.put(("token", (idx, tok)))
            elif kind == "serve_done":
                if pend.done.is_set():
                    # Hedged pair: the first terminal report won; the
                    # loser's later "cancelled" (or duplicate
                    # "completed") must not overwrite it.
                    continue
                pend.status = item.get("status")
                pend.reason = item.get("reason")
                pend.error = item.get("error")
                if item.get("tokens"):
                    pend.tokens = [int(t) for t in item["tokens"]]
                pend.stream.put(("done", None))
                pend.done.set()

    def close(self) -> None:
        self._closed.set()
        self._replies.shutdown()
        self._inbox.close()
