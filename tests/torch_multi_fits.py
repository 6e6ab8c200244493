"""Fits of the port's strategies and of the JAX package on matching CPU
meshes, for the multi-GPU test files (``tests/test_torch_megastep_dist.py``,
``test_torch_zero_int8.py``, ``test_torch_hybrid_zero.py``): the same
narrow GPT, the same seeded numpy batches and the same JAX init tree on
both sides.  The port's fits run on CPU workers over gloo, each kept
workers' pool reused across a file's fits (one spawn a file); the JAX fits
run ``run_fit`` over the first ``n`` of the CPU test devices, in the mesh
the port's ranks lay out."""

from __future__ import annotations

import contextlib
import signal
from typing import Any, Dict, Optional

import jax
import numpy as np
import torch

import torch_dist_helpers as helpers
from ray_lightning_tpu.core import loop as jax_loop
from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import NumpyLoader as JaxNumpyLoader
from ray_lightning_tpu.core.data import TpuDataModule as JaxDataModule
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from ray_lightning_tpu.parallel.mesh import build_mesh as jax_build_mesh
from ray_lightning_tpu.utils import state_stream as jax_ss
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
           warmup_steps=2, mu_dtype="float32")
WORKER = dict(device="cpu", timeout_s=120.0,
              env_per_worker={"OMP_NUM_THREADS": "1"})
LIMIT_S = 300


@contextlib.contextmanager
def limit(seconds: int = LIMIT_S):
    """Fail past ``seconds`` instead of letting a hung collective hold the
    suite."""
    def expire(signum, frame):
        raise TimeoutError(f"multi-process test exceeded {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def batches(steps: int, batch: int, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, CFG["vocab_size"], size=(
        steps * batch, CFG["seq_len"] + 1)).astype(np.int32)}


def init_tree(seed: int = 0) -> Any:
    return jax.tree.map(np.asarray, JaxGPT(JaxGPTConfig(**CFG)).init_params(
        jax.random.PRNGKey(seed)))


class KeptWorkers(Trainer):
    """A Trainer whose strategy's workers outlive the stage."""

    def _run_strategy(self, kind, *args, **kwargs):
        return self.strategy.run(kind, *args, **kwargs)


def on_pool(pool, cls, n: int, **kw):
    """A strategy of ``cls`` over the first ``n`` workers of ``pool``."""
    s = cls(num_workers=n, **WORKER, **kw)
    s._backend, s._workers = pool._backend, pool._workers[:n]
    return s


def port_fit(strategy, tree, arrays, batch: int, root, cfg=None,
             epochs: int = 1, callbacks=(), **trainer_kw):
    """A fit of the narrow GPT (``cfg`` over :data:`CFG`) from ``tree``
    through ``strategy`` (a kept-workers one: :class:`KeptWorkers`)."""
    m = GPT(GPTConfig(**{**CFG, **(cfg or {})}), device="cpu")
    m.initial_params = params_from_jax(tree, "cpu")
    trainer_kw.setdefault("enable_checkpointing", False)
    tr = KeptWorkers(strategy, max_epochs=epochs, limit_val_batches=0,
                     log_every_n_steps=1, default_root_dir=str(root),
                     callbacks=[helpers.LossLog(), *callbacks], **trainer_kw)
    with limit():
        tr.fit(m, helpers.ArraysDataModule(arrays, batch))
    return tr


class JaxArrays(JaxDataModule):
    def __init__(self, arrays, batch_size):
        super().__init__()
        self.arrays, self.batch_size = arrays, batch_size

    def train_dataloader(self):
        return JaxNumpyLoader(JaxArrayDataset(**self.arrays),
                              batch_size=self.batch_size,
                              shard_index=self.shard_index,
                              num_shards=self.num_shards)


def jax_fit(tree, arrays, batch: int, root, axes: Dict[str, int],
            zero_stage: int = 0, cfg=None, grad_comm=None,
            **fit_kw) -> Dict[str, Any]:
    """``run_fit`` of the JAX package over a mesh of ``axes`` on the first
    devices (rank r's place is device r's): the gathered state, its params
    by path, and the callback metrics."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_build_mesh(JaxMeshSpec(dict(axes)),
                          devices=jax.devices()[:n])
    m = JaxGPT(JaxGPTConfig(**{**CFG, **(cfg or {})}))
    m.initial_params = tree
    res = jax_loop.run_fit(
        m, JaxArrays(arrays, batch),
        jax_loop.FitConfig(seed=0, default_root_dir=str(root),
                           limit_val_batches=0, log_every_n_steps=1,
                           **fit_kw),
        callbacks=[], mesh=mesh, zero_stage=zero_stage,
        grad_comm=grad_comm)
    state = jax_ss.load_state_stream(res["state_stream"])
    return {"state": state, "params": jax_by_path(state.params),
            "metrics": res["callback_metrics"]}


def jax_by_path(tree) -> Dict[str, np.ndarray]:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_by_path(tree) -> Dict[str, np.ndarray]:
    from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths

    return {"/".join(map(str, p)): t.detach().float().cpu().numpy()
            for p, t in leaves_with_paths(tree)}


def max_diff(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    assert set(a) == set(b), (sorted(set(a) ^ set(b)))[:6]
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def bitwise(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def losses(tr) -> Optional[list]:
    """Rank 0's per-step losses (``torch_dist_helpers.LossLog``)."""
    for cb in tr.callbacks:
        if isinstance(cb, helpers.LossLog):
            return list(cb.losses)
    return None
