"""The layer-axis split of ``ray_lightning_tpu/parallel/pipeline.py``
(:func:`layer_splits`, copied; the pipelines themselves are ROADMAP
Queue 1 items 3 and 4).  The backward-overlapped gradient sync cuts the
GPT trunk into segments at these bounds (``models/gpt.py``,
``parallel/overlap.py``)."""

from __future__ import annotations

__all__ = ["layer_splits"]


def layer_splits(n_layers: int, n_stages: int, *,
                 require_divisible: bool = False) -> tuple:
    """Contiguous stage boundaries over a stacked ``(L, ...)`` layer axis:
    ``(b_0, ..., b_P)``, stage ``p`` owning layers ``[b_p, b_{p+1})``; a
    remainder goes to the earliest stages (``require_divisible`` refuses
    one)."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layers < n_stages:
        raise ValueError(
            f"{n_layers} layers cannot fill {n_stages} pipeline stages "
            "(every stage needs at least one layer)"
        )
    if n_layers % n_stages and require_divisible:
        raise ValueError(
            f"layer axis has {n_layers} layers, not divisible into "
            f"{n_stages} pipeline stages"
        )
    base, extra = divmod(n_layers, n_stages)
    bounds = [0]
    for p in range(n_stages):
        bounds.append(bounds[-1] + base + (1 if p < extra else 0))
    return tuple(bounds)
