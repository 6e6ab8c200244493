"""The serve loop: continuous batching over a paged KV cache, with
multi-tenant LoRA.

As in ``ray_lightning_tpu/serve/engine.py``, the engine runs two step
families with fixed shapes: one bucket-padded prefill per admitted prompt
(a handful of bucket lengths) and one fixed-width decode step over the
``num_slots`` slot set.  Join on arrival, evict on finish, growth and
preemption all happen host-side between steps by changing the steps'
integer inputs (block tables, sequence lengths, current tokens, adapter
slots), never a shape.  With an adapter pool, every step applies each
row's own tenant through the BGMV kernel (``ops/lora.py``) at the qkv and
proj projections of every layer.

The engine is single-threaded over the device: drive it with
:meth:`step` / :meth:`run_until_idle`, or :meth:`generate` for one
request.  :meth:`submit` is thread-safe.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.generate import _reject_unmerged_lora
from ray_lightning_tpu_torch.serve.kv_cache import (
    PagedKVCache, paged_decode_step, paged_prefill, sample_tokens,
)
from ray_lightning_tpu_torch.serve.lora import AdapterPool
from ray_lightning_tpu_torch.serve.metrics import ServeStats
from ray_lightning_tpu_torch.serve.scheduler import (
    Request, Scheduler, derive_geometry,
)

__all__ = ["ServeConfig", "ServeEngine", "ServeHandle", "ServeRejected"]


class ServeRejected(RuntimeError):
    """Admission backpressure: the queue is full.  Typed so clients can
    retry with backoff without string matching."""


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (the slice of the JAX package's ``ServeConfig`` that
    the port serves)."""

    # Decode width: concurrent sequences in flight.
    num_slots: int = 8
    # Tokens per KV block.
    block_size: int = 16
    # Physical blocks in the pool (block 0 is the trash block).  None =
    # every slot at max_model_len plus one admission's worth of headroom —
    # preemption-free at full width.
    num_blocks: Optional[int] = None
    # Longest prompt+generation the engine admits.  None = the model's
    # positional table (cfg.seq_len).
    max_model_len: Optional[int] = None
    # Prefill bucket lengths (multiples of block_size).  None =
    # power-of-two block counts up to max_model_len.
    prefill_buckets: Optional[Sequence[int]] = None
    # Admission-queue bound: submissions beyond it are rejected at once.
    max_queue: int = 64
    # Multi-tenant LoRA: capacity of the resident adapter pool (0 = no
    # pool) and the rank every loaded adapter must have.
    max_adapters: int = 0
    adapter_rank: int = 0
    # Per-tenant admission bound (None = the shared max_queue only).
    max_queue_per_adapter: Optional[int] = None
    # Seed of the temperature>0 sampling streams.
    seed: int = 0


class ServeHandle:
    """Host-side future for one request."""

    def __init__(self, rid: str, request: Request):
        self.rid = rid
        self.request = request
        self._done = threading.Event()

    @property
    def status(self) -> str:
        return self.request.state.value

    @property
    def tokens(self) -> List[int]:
        return list(self.request.generated)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Generated tokens (prompt excluded).  Raises
        :class:`ServeRejected` on backpressure, ``TimeoutError`` when the
        request did not finish in time."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not finished within {timeout}s "
                f"(state={self.status})"
            )
        if self.request.done_reason == "rejected":
            raise ServeRejected(f"request {self.rid} rejected")
        return list(self.request.generated)


def _to_device(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class ServeEngine:
    """Continuous-batching inference engine for one GPT module.

    Args:
        module: the ``GPT`` (its config and precision).
        params: a lora-free float parameter tree; moved to ``device``.
        adapters: ``{name: adapter}`` loaded into the pool at build
            (needs ``config.max_adapters > 0``).
        device: where to serve; ``None`` means ``"cuda"`` (raises without
            a card).
    """

    def __init__(self, module, params: Dict[str, Any],
                 config: Optional[ServeConfig] = None,
                 adapters: Optional[Dict[str, dict]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.module = module
        self.cfg = module.config
        self.config = cfg = config or ServeConfig()
        _reject_unmerged_lora(params)
        self.params = _to_device(params, self.device)
        self._c = module._compute_dtype()
        self.adapters: Optional[AdapterPool] = None
        if cfg.max_adapters > 0:
            if cfg.adapter_rank < 1:
                raise ValueError(
                    "max_adapters > 0 needs adapter_rank >= 1 (the "
                    "stacked-buffer rank every adapter shares)"
                )
            self.adapters = AdapterPool(
                self.cfg, cfg.max_adapters, cfg.adapter_rank,
                dtype=self._c, device=self.device, impl="kernel",
            )
            for name, adapter in (adapters or {}).items():
                self.adapters.add(name, adapter)
        elif adapters:
            raise ValueError(
                "adapters= passed but ServeConfig.max_adapters is 0 — "
                "size the pool (max_adapters/adapter_rank) to serve "
                "multi-tenant LoRA"
            )
        self._lora_impl = "kernel" if self.adapters is None \
            else self.adapters.impl
        if (cfg.max_model_len or 0) > self.cfg.seq_len:
            raise ValueError(
                f"max_model_len {cfg.max_model_len} exceeds the "
                f"positional table ({self.cfg.seq_len})"
            )
        self.max_model_len, buckets = derive_geometry(cfg, self.cfg)
        blocks_per_seq = -(-self.max_model_len // cfg.block_size)
        num_blocks = cfg.num_blocks
        if num_blocks is None:
            num_blocks = (cfg.num_slots + 1) * blocks_per_seq + 1
        if num_blocks - 1 < blocks_per_seq:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold even one "
                f"max-length sequence ({blocks_per_seq} blocks)"
            )
        self.cache = PagedKVCache(self.cfg, num_blocks, cfg.block_size,
                                  dtype=self._c, device=self.device)
        # The longest retained bucket bounds the admissible prompt length;
        # submit() enforces it, so bucket_for never raises in the loop.
        self.max_prompt_len = buckets[-1]
        self.scheduler = Scheduler(
            cfg.num_slots, self.cache.allocator, cfg.block_size,
            blocks_per_seq, buckets, max_queue=cfg.max_queue,
            max_queue_per_adapter=cfg.max_queue_per_adapter,
        )
        self.stats = ServeStats()
        self._pool = self.cache.init_pool()
        self._cur_tokens = np.zeros((cfg.num_slots,), np.int64)
        self._handles: Dict[str, ServeHandle] = {}  # guarded by self._lock
        self._lock = threading.Lock()

    # -- requests ------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               top_k: Optional[int] = None,
               adapter: Optional[str] = None,
               sample_seed: Optional[int] = None,
               on_token=None, rid: Optional[str] = None) -> ServeHandle:
        """Enqueue one request (thread-safe).  A backpressure rejection
        shows at once as ``handle.status == "rejected"`` (and ``result()``
        raises).  ``adapter`` decodes the request through that tenant's
        LoRA adapter; an unknown name or a pool-less engine is a
        ``ValueError``, never a silent fall back to the base model.
        ``sample_seed`` presets the request's sampling stream (None = the
        submission ordinal)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if top_k is not None:
            top_k = int(top_k)
            if top_k < 1:
                raise ValueError(f"top_k must be >= 1, got {top_k}")
            if temperature <= 0.0:
                raise ValueError(
                    "top_k requires temperature > 0 (temperature=0 is "
                    "greedy decoding, which would silently ignore it)"
                )
        if sample_seed is not None:
            sample_seed = int(sample_seed)
            if sample_seed < 0:
                raise ValueError(
                    f"sample_seed must be >= 0, got {sample_seed}"
                )
        if adapter is not None:
            adapter = str(adapter)
            if self.adapters is None:
                raise ValueError(
                    f"request names adapter {adapter!r} but this engine "
                    f"has no adapter pool — build it with "
                    f"ServeConfig(max_adapters=N, adapter_rank=r)"
                )
        if len(prompt) + max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})"
            )
        if len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds the largest prefill "
                f"bucket ({self.max_prompt_len}); raise max_model_len "
                f"to a multiple of block_size or pass prefill_buckets"
            )
        if any(not 0 <= t < self.cfg.vocab_size for t in prompt):
            raise ValueError("prompt token outside the vocab")
        rid = rid or uuid.uuid4().hex[:12]
        req = Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(temperature), eos_token_id=eos_token_id,
            top_k=top_k, adapter=adapter, sample_seed=sample_seed,
            on_token=on_token,
        )
        handle = ServeHandle(rid, req)
        with self._lock:
            if adapter is not None:
                # Resolved under the lock that enqueues: a concurrent
                # remove_adapter either completes first (unknown name) or
                # sees this request through references_adapter.
                try:
                    req._adapter_slot = self.adapters.slot_of(adapter)
                except KeyError:
                    raise ValueError(
                        f"unknown adapter {adapter!r} — load it first "
                        f"(engine.add_adapter)"
                    ) from None
            self.stats.bump("submitted")
            accepted = self.scheduler.submit(req)
            if accepted:
                self._handles[rid] = handle
        if not accepted:
            self.stats.bump("rejected")
            req.finished_t = time.monotonic()
            handle._done.set()
        return handle

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 **kw) -> List[int]:
        """Blocking convenience: submit, drive until idle, return the
        generated tokens."""
        handle = self.submit(prompt, max_new_tokens, **kw)
        self.run_until_idle()
        return handle.result(0)

    # -- the loop ------------------------------------------------------------
    def step(self) -> bool:
        """One serve iteration: admit (one bucketed prefill per
        admission), grow or preempt, one decode tick.  Returns True when
        any work was done."""
        with self._lock:
            admissions = self.scheduler.poll()
        worked = bool(admissions)
        now = time.monotonic()
        for slot, req, bucket in admissions:
            self.stats.note_admitted(now - req.arrival_t)
            self.stats.bump("prefills")
            first = self._prefill(slot, req, bucket)
            t_first = time.monotonic()
            self.stats.note_first_token(t_first - req.arrival_t)
            done = self.scheduler.append_token(slot, first, now=t_first)
            self.stats.bump("tokens_out")
            if req.adapter is not None:
                self.stats.note_adapter(req.adapter, tokens=1)
            self._cur_tokens[slot] = first
            if done:
                self._complete(slot)

        # Growth, and preemption of the youngest request when the pool is
        # dry, for every slot about to write past its blocks.
        active = [s for s, r in enumerate(self.scheduler.slots)
                  if r is not None]
        for slot in active:
            if self.scheduler.slots[slot] is None:
                continue  # preempted by an earlier slot's growth
            while self.scheduler.needs_block(slot):
                if self.scheduler.grow(slot):
                    break
                victim = self.scheduler.preempt_youngest(protect=slot)
                if victim is None:
                    raise RuntimeError(
                        "block pool exhausted with a single live "
                        "request — num_blocks below one sequence"
                    )
                self.stats.bump("preempted")

        active = [s for s, r in enumerate(self.scheduler.slots)
                  if r is not None]
        if active:
            worked = True
            self._decode_tick(active)
        self._refresh_gauges()
        return worked

    def _lora_inputs(self, slots: np.ndarray):
        """``(stacked adapter buffers, int32 slot ids on the device)``,
        or ``(None, None)`` without an adapter pool."""
        if self.adapters is None:
            return None, None
        return self.adapters.buffers, torch.tensor(
            slots, dtype=torch.int32, device=self.device
        )

    def _prefill(self, slot: int, req: Request, bucket: int) -> int:
        """Run the bucket's prefill for an admitted request; returns its
        first token."""
        dev = self.device
        ids = torch.tensor(
            self.scheduler._blocks[slot][: bucket // self.config.block_size],
            dtype=torch.long, device=dev,
        )
        padded = np.zeros((bucket,), np.int64)
        padded[: req.prompt_len] = req.prompt
        ad, ad_id = self._lora_inputs(np.array([req._adapter_slot]))
        logits, self._pool = paged_prefill(
            self.cfg, self.params, self._pool,
            torch.from_numpy(padded).to(dev), req.prompt_len, ids,
            compute_dtype=self._c, adapters=ad, adapter_id=ad_id,
            lora_impl=self._lora_impl,
        )
        first = sample_tokens(
            logits[None], [req.temperature], [req.top_k or 0],
            [req.sample_seed], [req.prompt_len - 1],
            base_seed=self.config.seed,
        )
        return int(first[0])  # the deliberate sync: TTFT lands here

    def _decode_tick(self, active: List[int]) -> None:
        """One token for every active slot."""
        t0 = time.monotonic()
        sch, dev = self.scheduler, self.device
        ad, ad_ids = self._lora_inputs(sch.adapter_slots)
        logits, self._pool = paged_decode_step(
            self.cfg, self.params, self._pool,
            torch.tensor(sch.block_tables, device=dev),
            torch.tensor(sch.seq_lens, device=dev),
            torch.tensor(self._cur_tokens, device=dev),
            compute_dtype=self._c, adapters=ad, adapter_ids=ad_ids,
            lora_impl=self._lora_impl,
        )
        toks = sample_tokens(
            logits, sch.temperatures.tolist(), sch.top_ks.tolist(),
            sch.sample_seeds.tolist(), sch.seq_lens.tolist(),
            base_seed=self.config.seed,
        ).tolist()  # the tick's one sync: it must emit tokens
        dt = time.monotonic() - t0
        self.stats.bump("decode_steps")
        self.stats.note_token_latency(dt, n_tokens=len(active))
        for slot in active:
            sch.seq_lens[slot] += 1
            tok = toks[slot]
            self._cur_tokens[slot] = tok
            req = sch.slots[slot]
            if req.adapter is not None:
                self.stats.note_adapter(req.adapter, tokens=1)
            if sch.append_token(slot, tok):
                self._complete(slot)

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Drive the loop until the queue and the slots drain."""
        for _ in range(max_steps):
            self.step()
            if not self.scheduler.has_work():
                return
        raise RuntimeError(f"still busy after {max_steps} serve steps")

    def _complete(self, slot: int) -> None:
        req = self.scheduler.finish(slot)
        self.stats.note_completed(req.finished_t - req.arrival_t)
        if req.adapter is not None:
            self.stats.note_adapter(req.adapter, completed=1)
        self._finish_handle(req)

    def _finish_handle(self, req: Request) -> None:
        with self._lock:
            handle = self._handles.pop(req.rid, None)
        if handle is not None:
            handle._done.set()

    # -- multi-tenant LoRA ---------------------------------------------------
    def add_adapter(self, name: str, adapter: dict) -> int:
        """Load (or replace) one tenant's LoRA adapter; returns its pool
        slot.  Replacing an adapter a queued or active request decodes
        through is refused: its model would change mid-stream."""
        if self.adapters is None:
            raise ValueError(
                "engine has no adapter pool — build it with "
                "ServeConfig(max_adapters=N, adapter_rank=r)"
            )
        name = str(name)
        with self._lock:
            if self.adapters.has(name) \
                    and self.scheduler.references_adapter(name):
                raise RuntimeError(
                    f"adapter {name!r} is serving queued/active "
                    f"requests — replacing its factors would change "
                    f"their model mid-stream; drain the tenant first"
                )
            slot = self.adapters.add(name, adapter)
        self.stats.bump("adapter_loads")
        return slot

    def remove_adapter(self, name: str) -> None:
        """Free one tenant's pool slot; refused while a queued or active
        request references the name (a re-issued slot would serve it
        another tenant's delta)."""
        if self.adapters is None:
            raise ValueError("engine has no adapter pool")
        name = str(name)
        with self._lock:
            if self.scheduler.references_adapter(name):
                raise RuntimeError(
                    f"adapter {name!r} is serving queued/active "
                    f"requests — drain the tenant before removing it"
                )
            self.adapters.remove(name)
        self.stats.bump("adapter_unloads")

    def cancel(self, rid: str) -> bool:
        """Drop one request wherever it is, queued or mid-decode.
        Idempotent: unknown or finished rids return False."""
        with self._lock:
            req = self.scheduler.cancel(rid)
            if req is None:
                return False
            handle = self._handles.pop(rid, None)
        self.stats.bump("cancelled")
        req.finished_t = time.monotonic()
        if handle is not None:
            handle._done.set()
        return True

    # -- telemetry -----------------------------------------------------------
    def _refresh_gauges(self) -> None:
        gauges = self.scheduler.snapshot()
        if self.adapters is not None:
            pool = self.adapters.snapshot()
            gauges["lora_adapters_loaded"] = pool["loaded"]
            gauges["lora_slots_free"] = pool["slots_free"]
            counts = [t for t in
                      self.stats.adapter_token_counts().values() if t]
            # Fairness spread: min/max lifetime tokens across tenants
            # with traffic (1.0 = perfectly fair).
            gauges["lora_fairness_spread"] = (
                min(counts) / max(counts) if len(counts) > 1 else 1.0
            )
        self.stats.set_gauges(**gauges)

    def snapshot(self) -> dict:
        """The live serve snapshot: counters, gauges, latency summaries
        and, on adapter-pool engines, the per-tenant block."""
        return self.stats.snapshot()
