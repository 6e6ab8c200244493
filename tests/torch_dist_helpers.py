"""Picklable pieces of the port's multi-process tests.

The port's workers get every class and function by reference (stdlib
pickle), so what a test ships to them lives in an importable module;
this one imports neither jax nor the JAX package, so a worker that
unpickles it loads only the port.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Dict

import numpy as np
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import (
    ArrayDataset, NumpyLoader, TpuDataModule,
)
from ray_lightning_tpu_torch.models.gpt import GPT

# The loss scale of each step's batch: the clip (global norm 1.0) binds at
# the first and third steps (norm ~1.4 unscaled) and not at the second, so
# a clip that took another norm than the global one moves the later
# updates (AdamW's update is blind to one common scale of every step).
SCALES = (60.0, 0.02, 1.0)


def scaled_batches(vocab: int, seq_len: int, batch: int, steps: int,
                   seed: int) -> Dict[str, np.ndarray]:
    """``steps`` global batches of tokens, each row with its batch's loss
    scale (rows of one batch share it)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(batch * steps, seq_len + 1)
                          ).astype(np.int32)
    scale = np.repeat(np.asarray(SCALES[:steps], np.float32), batch)
    return {"tokens": tokens, "scale": scale}


class ScaledGPT(GPT):
    """GPT whose training loss is scaled by its batch's ``scale``."""

    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        return loss * batch["scale"].mean(), logs


class ArraysDataModule(TpuDataModule):
    """Fixed numpy arrays as train, val, test and predict loaders of
    ``batch_size`` global rows (the rank's share after ``set_shard``)."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int):
        super().__init__()
        self.arrays = arrays
        self.batch_size = batch_size

    def _loader(self):
        return NumpyLoader(ArrayDataset(**self.arrays),
                           batch_size=self.batch_size,
                           shard_index=self.shard_index,
                           num_shards=self.num_shards)

    train_dataloader = val_dataloader = test_dataloader = _loader
    predict_dataloader = _loader


def write_marker(directory: str) -> None:
    """An ``init_hook``: a file named after the worker's pid."""
    with open(os.path.join(directory, f"hook-{os.getpid()}"), "w") as f:
        f.write("ran")


class RankProbe(Callback):
    """Writes, from each rank, its session rank, the trainer's world size
    and rank, and the elements of params and optimizer state it holds
    (the leaves whose shape a ZeRO slice changes, and the rest)."""

    def __init__(self, directory: str):
        self.directory = directory

    def on_fit_start(self, trainer, module) -> None:
        from ray_lightning_tpu_torch.models.optim import tree_leaves
        from ray_lightning_tpu_torch.session import get_actor_rank

        rank = get_actor_rank()
        st = trainer.state
        record = {
            "session_rank": rank, "global_rank": trainer.global_rank,
            "world_size": trainer.world_size,
            "params": [list(t.shape) for t in tree_leaves(st.params)],
            "opt": [list(t.shape) for t in tree_leaves(st.opt_state)],
            # The bytes the state's tensors keep alive (a slice that is a
            # view keeps its whole leaf's storage).
            "storage": sum(t.untyped_storage().nbytes() for t in
                           tree_leaves((st.params, st.opt_state))),
            "elements": sum(t.numel() * t.element_size() for t in
                            tree_leaves((st.params, st.opt_state))),
        }
        with open(os.path.join(self.directory, f"rank{rank}.txt"), "w") as f:
            f.write(repr(record))


class LossLog(Callback):
    """Each step's ``train_loss`` (as the loop logs it: under a strategy,
    the mean over the ranks); travels back as the callback's state."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        self.losses.append(float(logs["train_loss"]))

    def state_dict(self):
        return {"losses": list(self.losses)}

    def load_state_dict(self, state):
        self.losses = list(state["losses"])


class Exploding(GPT):
    """Fails in the worker, inside the fit."""

    def configure_optimizers(self):
        raise RuntimeError("worker-side boom")


# -- chip_smoke.py phase 15: what each rank measured --------------------------

# label -> rank -> the rank's record, filled in the driver by the thunks the
# ranks put on the queue (``record``).
RECORDS: Dict[str, Dict[int, Dict[str, Any]]] = {}


def record(label: str, rank: int, payload: Dict[str, Any]) -> None:
    """Runs in the driver (a thunk off the queue), or in-process for a
    local fit."""
    RECORDS.setdefault(label, {})[rank] = payload


def kernel_launches() -> Dict[str, int]:
    """The training kernels' launch counters of this process."""
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    return {"ln_fwd": ln.ln_fwd.launches, "ln_bwd": ln.ln_bwd.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches,
            "ce_fwd": ce.ce_fwd.launches, "ce_bwd_dx": ce.ce_bwd_dx.launches,
            "ce_bwd_dw": ce.ce_bwd_dw.launches}


def _zero_launches() -> None:
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    for fn in (ln.ln_fwd, ln.ln_bwd, fa.flash_fwd, fa.flash_bwd, ce.ce_fwd,
               ce.ce_bwd_dx, ce.ce_bwd_dw):
        fn.launches = 0


def vector_leaves(params: Any) -> Dict[str, torch.Tensor]:
    """Host copies of the GPT's vector leaves (the LN gains ``*_g`` and
    every bias ``*_b``), keyed by path as ``chip_smoke.by_path`` keys
    them."""
    from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths

    return {"".join(f"['{k}']" for k in path): t.detach().cpu().clone()
            for path, t in leaves_with_paths(params)
            if str(path[-1]).endswith(("_g", "_b"))}


class StepProbe(Callback):
    """The rank's ``memory_allocated`` once the state is built and its
    peak over the steps (on a card), each step's wall time (the card
    synchronised at each step's end), its kernel launches (counts set to
    0 at the fit's start), the per-step losses, the wall-clock times of
    the fit's start and end, and on one rank the vector leaves of the
    initial params (:func:`vector_leaves`); delivered to the driver's
    :data:`RECORDS` under ``label``."""

    def __init__(self, label: str):
        self.label = label

    def _sync(self, trainer) -> None:
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    def on_fit_start(self, trainer, module) -> None:
        import time

        self._sync(trainer)
        cuda = trainer.device.type == "cuda"
        self._setup_bytes = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        self._init = (vector_leaves(trainer.state.params)
                      if trainer.world_size == 1 else {})
        self._times, self._losses = [], []
        self._start = time.time()
        self._t = time.perf_counter()

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        import time

        self._sync(trainer)
        now = time.perf_counter()
        self._times.append(now - self._t)
        self._t = now
        self._losses.append(float(logs["train_loss"]))

    def on_fit_end(self, trainer, module) -> None:
        import time

        from ray_lightning_tpu_torch import session

        cuda = trainer.device.type == "cuda"
        payload = {"setup_bytes": self._setup_bytes,
                   "peak_bytes": (torch.cuda.max_memory_allocated()
                                  if cuda else 0),
                   "step_s": self._times, "losses": self._losses,
                   "launches": kernel_launches(),
                   "device": str(trainer.device),
                   "init_vectors": self._init,
                   "fit_start": self._start, "fit_end": time.time()}
        if session.is_session_enabled():
            import functools

            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


def warm_up(device: str) -> None:
    """An ``init_hook``: import the port's model (torch, the kernels'
    wrappers and all) before the worker's first task, and on a card run
    one bf16 step of a one-layer GPT of GPT-2-small's width (the kernels,
    remat "dots+flash", CE over the 50304-token vocabulary) on 2 x 1024
    tokens, so the CUDA context, the kernels' libraries and PyTorch's
    own kernels are loaded before the fit's first step."""
    gpt = importlib.import_module("ray_lightning_tpu_torch.models.gpt")
    if device != "cuda":
        return
    from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads

    cfg = gpt.GPTConfig(n_layer=1)
    module = gpt.GPT(cfg, precision="bf16", remat=True,
                     remat_policy="dots+flash")
    params = module.init_params(torch.Generator("cuda").manual_seed(0))
    tokens = torch.zeros((2, cfg.seq_len + 1), dtype=torch.int32,
                         device="cuda")
    loss_and_grads(module, params, {"tokens": tokens}, None)
    torch.cuda.synchronize()
    del params
    torch.cuda.empty_cache()
