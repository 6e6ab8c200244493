"""Prefill workers of the disaggregated serving plane, as in
``ray_lightning_tpu/serve/dist/prefill.py``.

A long prompt stalls every stream of a monolithic engine for one trunk
forward.  A prefill worker takes that work off the decode replicas: it
runs the same :func:`paged_prefill` the engine would (through the
tenant's adapter, so the BGMV runs here), exports the prompt's k/v blocks
to the host (``PagedKVCache.export_blocks``) and ships them with the last
position's logits to the chosen replica's inbox as a ``serve_kv_handoff``
frame.  The replica scatters them into its own blocks and goes straight
to decode.

Same-host payloads at or above ``_SHM_THRESHOLD_BYTES`` ride ``rlt-kv``
tmpfs segments (the consuming replica unlinks on read); smaller or
cross-host ones ride inline.  Segments no replica read (it died between
handoff and read) are pruned after ``_SEGMENT_TTL_S``, and swept by pid
at every teardown.  The JAX worker compiles its prefill through
``ledgered_jit``; the port calls the eager functions and keeps no program
ledger.
"""

from __future__ import annotations

import logging
import os
import queue as _pyqueue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.serve.dist.handoff import (
    KV_SEGMENT_PREFIX, CachedSender, encode_kv_payload, make_beat_item,
    make_handoff_item, make_hello_item,
)

__all__ = ["PrefillRunner"]

log = logging.getLogger(__name__)

# Same-host handoffs at or above this ride tmpfs segments (one tmpfs
# write against the socket buffers both ways).
_SHM_THRESHOLD_BYTES = 256 << 10
# Unread segments older than this are presumed addressed to a dead
# replica and unlinked (read ones are gone already).
_SEGMENT_TTL_S = 120.0


class PrefillRunner:
    """One prefill worker: its inbox, its pool, its adapter pool and
    prefix cache, and the handoff send path.  Drive it on a thread
    (:meth:`run`, as ``replica.InprocPrefill`` does) or one dispatch at a
    time with :meth:`step`."""

    def __init__(self, worker_id: str, module, params, serve_cfg,
                 beat_handle, *, beat_s: float = 0.25,
                 shm_threshold: int = _SHM_THRESHOLD_BYTES,
                 trace_dir: Optional[str] = None, device=None):
        from ray_lightning_tpu_torch.cluster.queue import DriverQueue
        from ray_lightning_tpu_torch.device import resolve_device
        from ray_lightning_tpu_torch.models.generate import (
            _reject_unmerged_lora,
        )
        from ray_lightning_tpu_torch.serve.kv_cache import (
            PagedKVCache, PrefixIndex, prepare_params,
        )
        from ray_lightning_tpu_torch.serve.scheduler import derive_geometry
        from ray_lightning_tpu_torch.telemetry.spans import SpanTracer

        self.worker_id = worker_id
        self.device = resolve_device(device)
        self.module = module
        self.cfg = module.config
        self.serve_cfg = serve_cfg
        _reject_unmerged_lora(params)
        self._c = module._compute_dtype()
        self.params = prepare_params(params, self._c, self.device)
        self.max_model_len, self.buckets = derive_geometry(serve_cfg,
                                                           self.cfg)
        # One prompt in flight at a time (the dispatch loop is
        # sequential): the largest bucket's blocks plus the trash block.
        # With the prefix cache the pool also keeps resident chains
        # between dispatches, so it is sized like an engine's.
        blocks_per_bucket = self.buckets[-1] // serve_cfg.block_size
        pool_blocks = blocks_per_bucket + 1
        if serve_cfg.prefix_cache:
            pool_blocks = max(pool_blocks, serve_cfg.num_blocks
                              or 4 * blocks_per_bucket + 1)
        self.cache = PagedKVCache(self.cfg, pool_blocks,
                                  serve_cfg.block_size, dtype=self._c,
                                  device=self.device)
        self._pool = self.cache.init_pool()
        # A tenant's prompt is prefilled through its adapter, or the k/v
        # handed off would be the base model's: the worker mirrors the
        # replicas' adapter pool, fed by the same serve_adapter_load
        # frames.
        self.adapters = None
        if serve_cfg.max_adapters > 0:
            from ray_lightning_tpu_torch.serve.lora import AdapterPool

            self.adapters = AdapterPool(
                self.cfg, serve_cfg.max_adapters, serve_cfg.adapter_rank,
                dtype=self._c, device=self.device, impl="kernel",
            )
        self._lora_impl = "kernel" if self.adapters is None \
            else self.adapters.impl
        # A prompt sharing a resident whole-block prefix claims it and
        # computes only the suffix; the export still covers the bucket,
        # so the handoff frame is the same.
        self.prefix: Optional[PrefixIndex] = None
        if serve_cfg.prefix_cache:
            self.prefix = PrefixIndex(self.cache.allocator,
                                      serve_cfg.block_size)
        self._inbox = DriverQueue()
        self._beat_handle = beat_handle
        self.beat_s = beat_s
        self._shm_threshold = shm_threshold
        self._store = None           # SegmentStore, made at the first use
        self._out = CachedSender()
        # The work thread appends and the beat thread drains or prunes.
        self._feed_lock = threading.Lock()
        self._live_segments: List[Tuple[str, float]] = []  # _feed_lock
        self._done: List[Tuple[str, str]] = []    # guarded by _feed_lock
        self._failed: List[Tuple[str, str]] = []  # guarded by _feed_lock
        self._last_beat = 0.0
        self.prefills = 0
        self.suffix_prefills = 0  # dispatches over a claimed prefix
        # Spans continue the router-stamped request context and are
        # exported at close.
        self._trace_dir = trace_dir
        self.tracer = SpanTracer(enabled=trace_dir is not None,
                                 maxlen=16384, rank=0)
        # A hard kill sends no final beat: the router must take the death
        # path, not the planned drain's.
        self.suppress_final = False

    @property
    def handle(self):
        return self._inbox.handle

    def hello(self) -> None:
        """Register with the router: the inbox and the geometry placement
        and validation read."""
        self._beat_handle.put(make_hello_item(
            "prefill", self.worker_id,
            (self._inbox.handle.host, self._inbox.handle.port),
            max_prompt_len=self.buckets[-1],
            max_model_len=self.max_model_len,
            block_size=self.serve_cfg.block_size,
            max_adapters=self.serve_cfg.max_adapters,
        ))

    # -- the loop ------------------------------------------------------------
    def step(self, timeout: float = 0.1) -> bool:
        """Process at most one inbox item; True when one was."""
        try:
            item = self._inbox.get(timeout=timeout)
        except _pyqueue.Empty:
            return False
        try:
            with torch.no_grad():
                self._process(item)
        except Exception as e:  # noqa: BLE001 - a bad dispatch is a failed
            # rid the router re-routes, never the end of the worker
            rid = item.get("rid") if isinstance(item, dict) else None
            log.warning("prefill %s: dispatch failed: %s", self.worker_id,
                        e, exc_info=True)
            if rid is not None:
                with self._feed_lock:
                    self._failed.append((str(rid), repr(e)))
        return True

    def run(self, stop=None) -> None:
        """Serve dispatches until ``stop()`` is true.  Beats ride their own
        thread, so they keep flowing through a long prefill and the
        router never reads a busy worker as lost."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.hello()
        done = threading.Event()

        def beat_loop():
            while not done.is_set():
                self._maybe_beat()
                done.wait(min(self.beat_s, 0.1))

        beater = threading.Thread(
            target=beat_loop, name=f"rlt-prefill-beat-{self.worker_id}",
            daemon=True,
        )
        beater.start()
        try:
            while not (stop() if stop is not None else False):
                self.step(timeout=min(self.beat_s, 0.1))
        finally:
            done.set()
            beater.join(timeout=10)
            if not self.suppress_final:
                try:
                    # The last done/failed feed, flagged as a planned
                    # drain: without ``closing`` the router would read
                    # this scale-down as a death and respawn the worker.
                    self._maybe_beat(force=True, closing=True)
                except Exception:  # noqa: BLE001 - the router may be gone
                    pass
            self.close()

    def _process(self, item: Dict[str, Any]) -> None:
        if isinstance(item, dict) \
                and item.get("type") == "serve_adapter_load":
            # The router sends a tenant's load frame down this inbox ahead
            # of its dispatches, so resolution below never races it.
            from ray_lightning_tpu_torch.serve.lora import decode_adapter

            if self.adapters is None:
                raise ValueError(
                    "serve_adapter_load on a prefill worker without an "
                    "adapter pool (serve_cfg.max_adapters == 0)"
                )
            name = str(item["name"])
            if self.prefix is not None:
                # Chains prefilled through the old factors are stale.
                self.prefix.drop(name)
            self.adapters.add(name, decode_adapter(item))
            return
        if not (isinstance(item, dict)
                and item.get("type") == "serve_prefill_dispatch"):
            raise ValueError(
                f"unexpected item on prefill inbox: {type(item).__name__}"
            )
        req = item["req"]
        rid = str(req["rid"])
        adapter = req.get("adapter")
        ad, ad_id = None, None
        if self.adapters is not None:
            ad = self.adapters.buffers
            # An unknown tenant raises into the failed feed (the router
            # re-routes and re-sends the load): never a base-model
            # prefill of a tenant's prompt.
            slot = 0 if adapter is None else self.adapters.slot_of(adapter)
            ad_id = torch.tensor([slot], dtype=torch.int32,
                                 device=self.device)
        elif adapter is not None:
            raise ValueError(
                f"dispatch names adapter {adapter!r} but this worker has "
                f"no adapter pool"
            )
        prompt = [int(t) for t in req["prompt"]]
        Bs = self.serve_cfg.block_size
        bucket = next(b for b in self.buckets if b >= len(prompt))
        n_blocks = bucket // Bs
        claimed: List[int] = []
        if self.prefix is not None:
            # The engine's cap: the last prompt token's block is computed
            # here, since its forward yields the logits the frame ships.
            claimed = self.prefix.claim(adapter, prompt,
                                        (len(prompt) - 1) // Bs)
        start = len(claimed) * Bs
        alloc = self.cache.allocator
        ids = alloc.alloc(n_blocks - len(claimed))
        if ids is None and self.prefix is not None:
            # Cache pressure: evict cold chains, then fall back to a full
            # recompute with the cache flushed; never fail the dispatch.
            self.prefix.evict(n_blocks - len(claimed))
            ids = alloc.alloc(n_blocks - len(claimed))
            if ids is None:
                if claimed:
                    alloc.free(claimed)
                    claimed, start = [], 0
                self.prefix.evict(n_blocks)
                ids = alloc.alloc(n_blocks)
            if ids is None:
                self.prefix.drop_all()
                ids = alloc.alloc(n_blocks)
        assert ids is not None, "worker pool sized for the largest bucket"
        ids = list(claimed) + list(ids)
        ctx = None
        if self.tracer.enabled:
            from ray_lightning_tpu_torch.telemetry.propagate import (
                child_context, extract,
            )

            ctx = extract(req)  # the router-stamped trace root
            pf_ctx = child_context(ctx) if ctx is not None else None
        t0 = time.time()
        ok = False
        try:
            logits = self._prefill(prompt, bucket, start, ids, ad, ad_id)
            # The host copy syncs the device: the span is the compute.
            kv = self.cache.export_blocks(self._pool, ids)
            ok = True
        finally:
            if ok and self.prefix is not None:
                # Publish the whole-block prefix; the index keeps the
                # chain, so the free below drops only this dispatch's
                # references.
                n_full = len(prompt) // Bs
                if n_full:
                    self.prefix.insert(adapter, prompt, ids[:n_full])
            alloc.free(ids)
        t1 = time.time()
        send_ctx = None
        if ctx is not None:
            from ray_lightning_tpu_torch.telemetry.propagate import (
                child_context, trace_args,
            )

            self.tracer.record("prefill_compute", t0, t1 - t0,
                               args=trace_args(pf_ctx, rid=rid,
                                               worker=self.worker_id,
                                               bucket=bucket))
            send_ctx = child_context(pf_ctx)
        payload = encode_kv_payload(kv, logits)
        shm_path = None
        # The envelope carries the worker's span and send time: the
        # replica books handoff_transfer from it.
        if item.get("same_host", False) \
                and len(payload) >= self._shm_threshold:
            shm_path = self._segment_store().put(payload)
            with self._feed_lock:  # the beat thread prunes concurrently
                self._live_segments.append((shm_path, time.monotonic()))
            out = make_handoff_item(req, bucket, shm=shm_path,
                                    trace=send_ctx)
        else:
            out = make_handoff_item(req, bucket, data=payload,
                                    trace=send_ctx)
        if send_ctx is not None:
            from ray_lightning_tpu_torch.telemetry.propagate import (
                trace_args,
            )

            self.tracer.record("handoff_send", t1, time.time() - t1,
                               args=trace_args(send_ctx, rid=rid))
        try:
            self._put(tuple(item["kv_to"]), out)
        except (OSError, ConnectionError) as e:
            # The replica's inbox is unreachable: reclaim the segment (no
            # consumer will) and report the rid for re-routing.
            if shm_path is not None:
                self._unlink(shm_path)
            with self._feed_lock:
                self._failed.append((rid, repr(e)))
            return
        self.prefills += 1
        with self._feed_lock:
            self._done.append((rid, "handoff"))

    def _prefill(self, prompt: List[int], bucket: int, start: int,
                 ids: List[int], ad, ad_id) -> np.ndarray:
        """The prompt's k/v into blocks ``ids`` (all of it, or the suffix
        past ``start`` over claimed blocks); returns the last prompt
        position's logits on the host, f32."""
        from ray_lightning_tpu_torch.serve.kv_cache import (
            paged_prefill, paged_verify_step,
        )

        dev = self.device
        Bs = self.serve_cfg.block_size
        if start == 0:
            padded = np.zeros((bucket,), np.int64)
            padded[: len(prompt)] = prompt
            logits, self._pool = paged_prefill(
                self.cfg, self.params, self._pool,
                torch.from_numpy(padded).to(dev), len(prompt),
                torch.tensor(ids, dtype=torch.long, device=dev),
                compute_dtype=self._c, adapters=ad, adapter_id=ad_id,
                lora_impl=self._lora_impl,
            )
        else:
            # The engine's suffix step: one row through the verify step,
            # its table cut to the blocks below the prompt's end.
            suffix = len(prompt) - start
            width = next(b for b in self.buckets if b >= suffix)
            window = np.zeros((1, width), np.int64)
            window[0, :suffix] = prompt[start:]
            n = -(-len(prompt) // Bs)
            table = torch.tensor([ids[:n]], dtype=torch.long, device=dev)
            logits, self._pool = paged_verify_step(
                self.cfg, self.params, self._pool, table,
                torch.tensor([start], device=dev),
                torch.from_numpy(window).to(dev),
                torch.tensor([len(prompt)], device=dev),
                compute_dtype=self._c, adapters=ad, adapter_ids=ad_id,
                lora_impl=self._lora_impl, head_at=suffix - 1,
            )
            logits = logits[0]
            self.suffix_prefills += 1
        return logits.float().cpu().numpy()

    # -- transport -------------------------------------------------------------
    def _segment_store(self):
        if self._store is None:
            from ray_lightning_tpu_torch.cluster.shm import SegmentStore

            self._store = SegmentStore(prefix=KV_SEGMENT_PREFIX)
        return self._store

    def _put(self, addr: Tuple[str, int], item: Dict[str, Any]) -> None:
        self._out.put(addr, item)

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def _prune_segments(self, now: float) -> None:
        """Unlink handoff segments past their TTL: the replica they were
        addressed to died before reading them, and this producer is
        alive, so the pid sweep would not collect them."""
        with self._feed_lock:
            expired = [p for p, t in self._live_segments
                       if now - t > _SEGMENT_TTL_S]
            self._live_segments = [
                (p, t) for p, t in self._live_segments
                if now - t <= _SEGMENT_TTL_S
            ]
        for path in expired:
            self._unlink(path)

    def _maybe_beat(self, force: bool = False,
                    closing: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_beat < self.beat_s:
            return
        self._last_beat = now
        self._prune_segments(now)
        with self._feed_lock:
            done, self._done = self._done, []
            failed, self._failed = self._failed, []
        try:
            self._beat_handle.put(make_beat_item(
                "prefill", self.worker_id, done=done, failed=failed,
                adapters=(None if self.adapters is None
                          else self.adapters.names()),
                closing=closing,
            ))
        except (OSError, ConnectionError):
            # The router is gone or restarting: keep the feeds for the
            # next beat.
            with self._feed_lock:
                self._done = done + self._done
                self._failed = failed + self._failed

    def close(self, consume_grace_s: float = 5.0) -> None:
        self._inbox.shutdown()
        self._out.close()
        if self.prefix is not None:
            self.prefix.drop_all()
        if self._trace_dir is not None and self.tracer.events():
            try:
                os.makedirs(self._trace_dir, exist_ok=True)
                self.tracer.export_jsonl(os.path.join(
                    self._trace_dir,
                    f"trace-prefill-{self.worker_id}.jsonl"))
            except OSError:
                pass  # a full disk must not fail the teardown
        if self._store is None:
            return
        # A handoff delivered to a busy replica may not be read yet:
        # unlinking it now would turn an accepted request "invalid" on a
        # planned scale-down.  The consumer unlinks on read, so wait a
        # short grace for the tracked segments to go first.
        deadline = time.monotonic() + consume_grace_s
        while time.monotonic() < deadline:
            with self._feed_lock:
                paths = [p for p, _ in self._live_segments]
            if not any(os.path.exists(p) for p in paths):
                break
            time.sleep(0.05)
        self._store.unlink_all()
