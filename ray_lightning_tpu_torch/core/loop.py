"""The fit loop on one device: the spine of ``run_fit``
(``ray_lightning_tpu/core/loop.py``).

Kept: epochs, ``max_steps``, ``limit_train_batches``/``limit_val_batches``,
``log_every_n_steps`` (step logs land in ``callback_metrics`` one log
interval late, as the JAX package's asynchronous fetch lands them),
``check_val_every_n_epoch``, the epoch means of the step logs with
non-finite values left out (``_RunningMeanLogs``), validation, the module
and callback hooks, ``initial_params`` warm starts, and
``module.precision = config.precision``.  Gradient accumulation,
megastep, checkpoints and resume, elastic restart, drain, prefetch threads
and telemetry are later slices: :class:`FitConfig` refuses them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import TpuDataModule
from ray_lightning_tpu_torch.core.module import TrainModule, TrainState
from ray_lightning_tpu_torch.models.optim import tree_map
from ray_lightning_tpu_torch.parallel import step_fns

__all__ = ["FitConfig", "LoopContext", "init_train_state", "run_fit"]

_PRECISION_ALIASES = {"32": "f32", "32-true": "f32", "float32": "f32",
                      "bf16-mixed": "bf16", "bfloat16": "bf16"}


@dataclasses.dataclass
class FitConfig:
    """The loop's configuration (the JAX package's ``FitConfig`` fields
    that the single-device loop reads).  ``accumulate_grad_batches`` and
    ``megastep`` exist to be refused until their slice."""

    max_epochs: int = 1
    max_steps: int = -1
    check_val_every_n_epoch: int = 1
    limit_train_batches: int = -1
    limit_val_batches: int = -1
    log_every_n_steps: int = 50
    seed: int = 0
    precision: str = "f32"
    accumulate_grad_batches: int = 1
    megastep: Optional[Any] = None

    def __post_init__(self):
        if self.limit_train_batches is None:
            self.limit_train_batches = -1
        if self.limit_val_batches is None:
            self.limit_val_batches = -1
        if self.max_steps is None:
            self.max_steps = -1
        if self.max_epochs is None:
            self.max_epochs = 1000
        self.precision = _PRECISION_ALIASES.get(str(self.precision),
                                                self.precision)
        if self.precision not in ("f32", "bf16"):
            raise ValueError(
                f"precision {self.precision!r} unsupported: use 'f32' or "
                f"'bf16' (accepted aliases: {sorted(_PRECISION_ALIASES)})")
        if self.accumulate_grad_batches != 1:
            raise NotImplementedError(
                "gradient accumulation is not supported by the PyTorch "
                "port yet (a later slice); use accumulate_grad_batches=1")
        if self.megastep not in (None, "off", 1):
            raise NotImplementedError(
                "megastep is not supported by the PyTorch port yet (a "
                "later slice ports it as CUDA-graph capture); leave it off")


class LoopContext:
    """The ``trainer`` argument of every hook (the JAX package's
    ``LoopContext``, one device)."""

    def __init__(self, config: FitConfig, device: torch.device):
        self.config = config
        self.device = device
        self.current_epoch = 0
        # global_step counts optimizer steps, micro_step micro-batches
        # (equal without accumulation).
        self.global_step = 0
        self.micro_step = 0
        self.should_stop = False
        self.callback_metrics: Dict[str, float] = {}
        self.logged_metrics: Dict[str, float] = {}
        self.state: Optional[TrainState] = None

    def log_metrics(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self.logged_metrics[k] = float(v)
            self.callback_metrics[k] = float(v)


def _call_hooks(callbacks: List[Callback], hook: str, *args) -> None:
    for cb in callbacks:
        getattr(cb, hook)(*args)


class _RunningMeanLogs:
    """Epoch means of device-scalar step logs: one f32 running sum and
    finite count per metric on the device (no host sync per step);
    non-finite values are left out of the mean, and a metric whose every
    value was non-finite reads NaN."""

    def __init__(self) -> None:
        self._sum: Optional[Dict[str, torch.Tensor]] = None
        self._cnt: Optional[Dict[str, torch.Tensor]] = None

    def update(self, logs: Dict[str, Any]) -> None:
        if self._sum is None:
            self._sum, self._cnt = {}, {}
            for k, v in logs.items():
                v32 = torch.as_tensor(v).float()
                finite = torch.isfinite(v32)
                self._sum[k] = torch.where(finite, v32, 0.0)
                self._cnt[k] = finite.float()
        else:
            for k in self._sum:
                v32 = torch.as_tensor(logs[k]).float()
                finite = torch.isfinite(v32)
                self._sum[k] = self._sum[k] + torch.where(finite, v32, 0.0)
                self._cnt[k] = self._cnt[k] + finite.float()

    def result(self) -> Dict[str, float]:
        if self._sum is None:
            return {}
        out: Dict[str, float] = {}
        for k, s in self._sum.items():
            c = float(self._cnt[k])
            out[k] = float(s) / c if c else float("nan")
        return out


def _place_batch(batch: Any, device: torch.device) -> Any:
    if isinstance(batch, dict):
        return {k: _place_batch(v, device) for k, v in batch.items()}
    return torch.as_tensor(np.asarray(batch)).to(device, non_blocking=True)


def init_train_state(module: TrainModule, tx, device: torch.device,
                     seed: int) -> TrainState:
    """The initial state on ``device``: ``module.initial_params`` when set
    (copied, in f32), else ``module.init_params`` from a generator seeded
    ``seed``."""
    preset = getattr(module, "initial_params", None)
    if preset is not None:
        params = tree_map(
            lambda t: torch.as_tensor(t).to(device=device,
                                            dtype=torch.float32).clone(),
            dict(preset))
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = tree_map(lambda t: t.to(device),
                          module.init_params(gen))
    return TrainState.create(params, tx)


def _run_validation(eval_step, loader, ctx: LoopContext,
                    limit: int) -> Dict[str, float]:
    acc = _RunningMeanLogs()
    for i, batch in enumerate(loader):
        if limit >= 0 and i >= limit:
            break
        acc.update(eval_step(ctx.state.params,
                             _place_batch(batch, ctx.device)))
    return acc.result()


def _step_generator(device: torch.device, seed: int,
                    micro_step: int) -> torch.Generator:
    """The ``rng`` handed to ``training_step``: seeded from the fit seed
    and the micro-step (the JAX package folds the step into its key)."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + micro_step)


def run_fit(module: TrainModule, datamodule: TpuDataModule,
            config: FitConfig, callbacks: List[Callback],
            device: torch.device) -> Dict[str, Any]:
    """The fit loop.  Returns the result package the trainer adopts:
    ``state``, ``callback_metrics``, ``logged_metrics``, ``epochs_run``,
    ``global_step`` and ``micro_step``."""
    tx = module.configure_optimizers()
    ctx = LoopContext(config, device)
    module.trainer = ctx
    module.precision = config.precision

    module.setup("fit")
    datamodule.set_shard(0, 1)
    datamodule.prepare_data()
    datamodule.setup("fit")
    _call_hooks(callbacks, "setup", ctx, module, "fit")

    ctx.state = init_train_state(module, tx, device, config.seed)
    train_step = step_fns.single_device_step(module, tx)
    val_loader = datamodule.val_dataloader()
    eval_step = (step_fns.eval_step(module) if val_loader is not None
                 else None)

    module.on_fit_start()
    _call_hooks(callbacks, "on_fit_start", ctx, module)

    train_loader = datamodule.train_dataloader()
    stop = False
    pending_logs: Optional[Dict[str, Any]] = None
    for epoch in range(config.max_epochs):
        ctx.current_epoch = epoch
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        module.on_train_epoch_start(epoch)
        _call_hooks(callbacks, "on_train_epoch_start", ctx, module)

        epoch_mean = _RunningMeanLogs()
        cap = (config.limit_train_batches
               if config.limit_train_batches >= 0 else None)
        if config.max_steps >= 0:
            remaining = max(config.max_steps - ctx.global_step, 0)
            cap = remaining if cap is None else min(cap, remaining)
        src = iter(train_loader)
        source = src if cap is None else itertools.islice(src, cap + 1)
        batch_idx = -1
        for batch in source:
            if (config.limit_train_batches >= 0
                    and batch_idx + 1 >= config.limit_train_batches):
                break
            if config.max_steps >= 0 and ctx.global_step >= config.max_steps:
                stop = True
                break
            rng = _step_generator(device, config.seed, ctx.micro_step)
            ctx.state, logs = train_step(
                ctx.state, _place_batch(batch, device), rng)
            epoch_mean.update(logs)
            prev_micro = ctx.micro_step
            ctx.micro_step += 1
            ctx.global_step += 1
            batch_idx += 1
            n_log = config.log_every_n_steps
            if n_log and ctx.micro_step // n_log > prev_micro // n_log:
                # The previous boundary's values are long computed by now:
                # landing them costs no wait on the step just issued.
                if pending_logs is not None:
                    ctx.log_metrics(pending_logs)
                pending_logs = logs
            _call_hooks(callbacks, "on_train_batch_end", ctx, module, logs,
                        batch_idx)

        if pending_logs is not None:
            ctx.log_metrics(pending_logs)
            pending_logs = None
        train_metrics = epoch_mean.result()
        ctx.log_metrics(train_metrics)
        module.on_train_epoch_end(epoch, train_metrics)

        if (eval_step is not None
                and (epoch + 1) % config.check_val_every_n_epoch == 0):
            val_metrics = _run_validation(eval_step, val_loader, ctx,
                                          config.limit_val_batches)
            ctx.log_metrics(val_metrics)
            module.on_validation_epoch_end(val_metrics)
            _call_hooks(callbacks, "on_validation_epoch_end", ctx, module)

        _call_hooks(callbacks, "on_train_epoch_end", ctx, module)
        if stop or ctx.should_stop:
            break

    module.on_fit_end()
    _call_hooks(callbacks, "on_fit_end", ctx, module)
    module.teardown("fit")
    _call_hooks(callbacks, "teardown", ctx, module, "fit")
    datamodule.teardown("fit")
    return {
        "state": ctx.state,
        "callback_metrics": dict(ctx.callback_metrics),
        "logged_metrics": dict(ctx.logged_metrics),
        "epochs_run": ctx.current_epoch + 1,
        "global_step": ctx.global_step,
        "micro_step": ctx.micro_step,
    }
