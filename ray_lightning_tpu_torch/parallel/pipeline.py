"""GPipe pipeline parallelism over a process group
(``ray_lightning_tpu/parallel/pipeline.py``): :func:`layer_splits`,
:func:`pipelined_scan` and :func:`pipeline_apply`.

The JAX package runs the pipeline as one SPMD program over a ``pipe``
mesh axis with ``ppermute`` handoffs.  Here the ``pipe`` axis is a
``torch.distributed`` process group, one rank a stage, every rank
running the same program:

* stage ``p`` runs its run of the stacked ``(L, ...)`` layers
  (``layer_splits``, an even split) on micro-batch ``t - p`` at tick
  ``t``; ``M`` micro-batches drain in ``M + P - 1`` ticks;
* ``ppermute`` is a point-to-point hop to the next rank inside a
  ``torch.autograd.Function`` whose backward is the reverse hop
  (``ops/ring_attention.py``'s hop: NCCL, gloo, and over gloo a card
  tensor staged through the host, since gloo's ``isend``/``irecv`` fail
  on card tensors);
* the bubble's slots are masked, not branched: every rank computes
  every tick and selects with ``torch.where``, so every rank's autograd
  graph is the same and the backward's hops pair up in the same order;
* the closing ``psum`` of the last stage's outputs is an all-reduce
  whose gradient is the cotangent as it is (``reduce_out``, the JAX
  transpose for outputs replicated over the pipe), and the replicated
  input's gradient is summed over the group (``copy_in``).

A one-rank group, or ``group=None``, is the plain scan over
micro-batches.  The backward-overlapped gradient sync cuts the GPT trunk
into segments at :func:`layer_splits` bounds too (``models/gpt.py``,
``parallel/overlap.py``), and the pipeline plane's stages
(``mpmd/plan.py``) balance a remainder onto the earliest stages.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

__all__ = ["layer_splits", "pipelined_scan", "pipeline_apply",
           "pipe_group"]


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


def pipe_group(group: Any):
    """The pipe axis as an ``AxisGroup`` (``parallel/model_parallel.py``):
    a ``torch.distributed`` process group, one rank a stage, in rank
    order; an ``AxisGroup`` as it is; None for ``None`` (one stage)."""
    from ray_lightning_tpu_torch.parallel.model_parallel import AxisGroup

    if group is None or isinstance(group, AxisGroup):
        return group
    import torch.distributed as dist

    ranks = tuple(dist.get_process_group_ranks(group))
    return AxisGroup(group, dist.get_rank(group), len(ranks), ranks)


def pipelined_scan(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   local_params: Any, x_micro: torch.Tensor,
                   group) -> torch.Tensor:
    """One rank's GPipe body over the pipe ``group`` (an ``AxisGroup``).

    ``stage_fn(local_params, x) -> x`` applies this stage's layer run to
    one micro-batch; ``x_micro`` is the ``(M, mb, ...)`` micro-batched
    input, the same on every rank (stage 0 reads it).  Returns the last
    stage's ``(M, mb, ...)`` outputs on every rank of the group."""
    from ray_lightning_tpu_torch.ops.ring_attention import _Hop
    from ray_lightning_tpu_torch.parallel.model_parallel import reduce_out

    n_stages, stage = group.size, group.index
    m = x_micro.shape[0]
    ticks = m + n_stages - 1
    dev = x_micro.device
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == n_stages - 1, device=dev)
    zeros = torch.zeros_like(x_micro[0])
    outputs = [torch.zeros_like(x_micro[0]) for _ in range(m)]
    prev_out = zeros
    for t in range(ticks):
        # The activation from the previous stage (stage 0 receives the
        # last stage's wrap-around and ignores it).
        arriving = _Hop.apply(prev_out, group)
        fed = x_micro[t] if t < m else zeros
        y = stage_fn(local_params, torch.where(is_first, fed, arriving))
        # The last stage completes micro-batch t - (P-1) at tick t.
        done = t - (n_stages - 1)
        idx = min(max(done, 0), m - 1)
        take = is_last & torch.tensor(done >= 0, device=dev)
        outputs[idx] = torch.where(take, y, outputs[idx])
        prev_out = y
    out = torch.stack(outputs)
    return reduce_out(torch.where(is_last, out, torch.zeros_like(out)),
                      group)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, group=None,
                   num_microbatches: Optional[int] = None) -> torch.Tensor:
    """Apply an ``(L, ...)``-stacked layer tree to ``x (B, ...)`` as a
    ``P``-stage pipeline over the pipe ``group`` (a process group, one
    rank a stage, or an ``AxisGroup``; None or one rank: the plain scan
    over micro-batches).

    Every rank passes the whole stack and the whole ``x`` and gets the
    whole output.  ``stage_fn(local_params, x)`` receives the rank's
    ``L/P`` layers.  The gradient of ``x`` is the JAX one on every rank;
    that of ``stacked_params`` holds this rank's layer rows (the others
    zero: a rank holds and trains its own stage).  The batch is split
    into ``num_microbatches`` (default: one a stage)."""
    from ray_lightning_tpu_torch.models.optim import tree_leaves, tree_map
    from ray_lightning_tpu_torch.parallel.model_parallel import copy_in

    g = pipe_group(group)
    n_stages = 1 if g is None else g.size
    if num_microbatches is not None and num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got "
                         f"{num_microbatches}")
    m = num_microbatches if num_microbatches is not None else n_stages
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    layers = {int(leaf.shape[0]) for leaf in tree_leaves(stacked_params)}
    if len(layers) != 1:
        raise ValueError(f"stacked params with layer counts {layers}")
    bounds = layer_splits(layers.pop(), n_stages, require_divisible=True)
    x_micro = x.reshape(m, b // m, *x.shape[1:])
    if n_stages == 1:
        out = torch.stack([stage_fn(stacked_params, xm) for xm in x_micro])
        return out.reshape(b, *out.shape[2:])
    lo, hi = bounds[g.index], bounds[g.index + 1]
    local = tree_map(lambda a: a[lo:hi], stacked_params)
    out = pipelined_scan(stage_fn, local, copy_in(x_micro, g), g)
    return out.reshape(b, *out.shape[2:])
