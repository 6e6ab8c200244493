"""Multi-tenant LoRA serving: one resident base model, many adapters.

:class:`AdapterPool` keeps up to ``max_adapters`` tenants' LoRA factors
stacked in device buffers — per hook site (attention qkv and proj) one
``(L, N+1, ...)`` tensor whose leading layer axis the engine's layer loop
walks like the KV pool — plus the host-side registry (name → slot, LIFO
free list).  Slot 0 is the null adapter (zero factors): requests without
an adapter ride the same dispatch with a delta of exactly 0.0.  Each
dispatch takes a per-row int32 slot id and applies ``y += (x @ A[id]) @
B[id]`` through ``ops/lora.py``.  Misuse (unknown name, rank drift,
capacity, a mis-shaped factor) raises a typed error instead of serving
one tenant garbage.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.ops.lora import LORA_IMPLS

__all__ = ["ADAPTER_KEYS", "AdapterPool", "validate_adapter"]

#: The four stacked factor tensors every adapter carries
#: (``models/gpt.py::extract_lora`` emits exactly these plus "scale").
ADAPTER_KEYS = ("qkv_a", "qkv_b", "proj_a", "proj_b")


def validate_adapter(adapter: Dict[str, Any], cfg, rank: int) -> None:
    """Shape and rank gate for one adapter against a pool's geometry;
    raises ``ValueError``."""
    if not isinstance(adapter, dict):
        raise ValueError(
            f"adapter must be a dict, got {type(adapter).__name__}"
        )
    missing = [k for k in ADAPTER_KEYS if k not in adapter]
    if missing:
        raise ValueError(f"adapter missing factor(s) {missing}")
    L, d = cfg.n_layer, cfg.d_model
    expect = {
        "qkv_a": (L, d, rank),
        "qkv_b": (L, rank, 3 * d),
        "proj_a": (L, d, rank),
        "proj_b": (L, rank, d),
    }
    for key, shape in expect.items():
        got = tuple(adapter[key].shape)
        if got != shape:
            raise ValueError(
                f"adapter factor {key!r} has shape {got}, pool expects "
                f"{shape} (rank {rank} over L={L}, d={d} — every "
                f"adapter in a pool shares the stacked-buffer rank)"
            )


def _as_f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


class AdapterPool:
    """Stacked adapter buffers on ``device`` plus the slot registry.

    Args:
        device: where the buffers live; ``None`` means ``"cuda"``.
        impl: the BGMV arm every dispatch uses, ``"kernel"`` (the CUDA
            kernel on CUDA tensors) or ``"plain"`` (``bgmv_plain``).

    Thread-safe registry.  :meth:`add` writes a slot's factors in place;
    on CUDA the copy is ordered on the stream after every dispatch
    already queued, so a tick in flight reads the factors it was issued
    with, and a new slot is only referenced after :meth:`add` returned.
    """

    def __init__(self, model_cfg, max_adapters: int, rank: int,
                 dtype: torch.dtype = torch.float32,
                 device=None, impl: str = "kernel"):
        if max_adapters < 1:
            raise ValueError(
                f"max_adapters must be >= 1, got {max_adapters}"
            )
        if rank < 1:
            raise ValueError(f"adapter rank must be >= 1, got {rank}")
        if impl not in LORA_IMPLS:
            raise ValueError(f"impl {impl!r} not in {LORA_IMPLS}")
        self.cfg = model_cfg
        self.max_adapters = max_adapters
        self.rank = rank
        self.dtype = dtype
        self.impl = impl
        device = resolve_device(device)
        L, d, N1 = model_cfg.n_layer, model_cfg.d_model, max_adapters + 1
        # Slot 0 = the null adapter: zero factors, delta exactly 0.0.
        shapes = {
            "qkv_a": (L, N1, d, rank),
            "qkv_b": (L, N1, rank, 3 * d),
            "proj_a": (L, N1, d, rank),
            "proj_b": (L, N1, rank, d),
        }
        self.buffers: Dict[str, torch.Tensor] = {
            k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in shapes.items()
        }
        self._slots: Dict[str, int] = {}      # guarded by self._lock
        # LIFO free list, as BlockAllocator: recently freed slots first.
        self._free: List[int] = list(range(max_adapters, 0, -1))
        self._lock = threading.Lock()
        self.loads = 0
        self.unloads = 0

    # -- registry ------------------------------------------------------------
    @property
    def loaded(self) -> int:
        with self._lock:
            return len(self._slots)

    @property
    def slots_free(self) -> int:
        with self._lock:
            return len(self._free)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    def slot_of(self, name: str) -> int:
        """Device slot of ``name``; ``KeyError`` when it is not loaded."""
        with self._lock:
            return self._slots[name]

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._slots

    # -- device mutation -----------------------------------------------------
    def add(self, name: str, adapter: Dict[str, Any]) -> int:
        """Load (or replace) ``name``'s factors; returns its slot.

        Replacing reuses the slot; the engine refuses to replace an
        adapter a queued or active request uses.  The adapter's scale is
        folded into its B factors here (in f32, then cast to the pool's
        dtype), so dispatches need no per-slot scale."""
        validate_adapter(adapter, self.cfg, self.rank)
        scale = float(adapter.get("scale", 1.0))
        factors = {
            "qkv_a": _as_f32(adapter["qkv_a"]),
            "qkv_b": _as_f32(adapter["qkv_b"]) * scale,
            "proj_a": _as_f32(adapter["proj_a"]),
            "proj_b": _as_f32(adapter["proj_b"]) * scale,
        }
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                if not self._free:
                    raise RuntimeError(
                        f"adapter pool full ({self.max_adapters} "
                        f"slots) — remove a tenant or raise "
                        f"ServeConfig.max_adapters"
                    )
                slot = self._free.pop()
                self._slots[name] = slot
            for k, buf in self.buffers.items():
                # In place where JAX used buffers.at[:, slot].set(...).
                buf[:, slot] = factors[k].to(device=buf.device,
                                             dtype=buf.dtype)
            self.loads += 1
            return slot

    def remove(self, name: str) -> None:
        """Free ``name``'s slot.  Its stale factors stay in the buffer
        until the slot is re-issued: no request can resolve the name."""
        with self._lock:
            slot = self._slots.pop(name, None)
            if slot is None:
                raise KeyError(f"adapter {name!r} is not loaded")
            self._free.append(slot)
            self.unloads += 1

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "loaded": len(self._slots),
                "slots_free": len(self._free),
                "max_adapters": self.max_adapters,
                "rank": self.rank,
                "loads": self.loads,
                "unloads": self.unloads,
                "impl": self.impl,
            }
