"""ZeRO's step collectives a bucket at a time (``parallel/sharding.py``),
held against the same step with one collective a leaf, on CPU ranks over
gloo, and against the JAX package.

Three steps of ZeRO-1, ZeRO-3 and (through ZeRO-1's step) the sharded
weight update, on the CPU tests' narrow GPT in f32 with the forged loss
scales that make the clip bind (``torch_dist_helpers.SCALES``), each from
the same params and batches with the bucketed plan and with the per-leaf
one (``torch_dist_helpers.per_leaf_plan``, the plan's first form).  At
two ranks a sum has one order, so the two steps are bitwise equal; at
three, gloo's reduction order may depend on the buffer it reduces, so the
bucketed step is held within the flavor tests' 2e-6 of the per-leaf step
and of the JAX package's ``LocalStrategy`` fit over the same global
batches.  Each step issues one reduce-scatter a bucket of sharded
gradients, one all-reduce a bucket of replicated ones (and one for the
clip's norm, one for the logs), and one all-gather a bucket of sharded
params (stage 1 after the update, stage 3 before the forward).
"""

import contextlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as helpers
from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import NumpyLoader as JaxNumpyLoader
from ray_lightning_tpu.core.data import TpuDataModule as JaxDataModule
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu_torch.parallel.strategies import RayStrategy

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
           warmup_steps=2, mu_dtype="float32")
# 24 rows a step: 12 a rank at two ranks, 8 at three, 3 a JAX CPU device.
BATCH, STEPS = 24, 3
WORKER = dict(device="cpu", timeout_s=120.0,
              env_per_worker={"OMP_NUM_THREADS": "1"})
LIMIT_S = 300


@contextlib.contextmanager
def _limit(seconds):
    def expire(signum, frame):
        raise TimeoutError(f"multi-process test exceeded {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


class JaxScaledGPT(JaxGPT):
    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        return loss * jnp.mean(batch["scale"]), logs


class JaxArrays(JaxDataModule):
    def __init__(self, arrays, batch_size):
        super().__init__()
        self.arrays, self.batch_size = arrays, batch_size

    def train_dataloader(self):
        return JaxNumpyLoader(JaxArrayDataset(**self.arrays),
                              batch_size=self.batch_size,
                              shard_index=self.shard_index,
                              num_shards=self.num_shards)


@pytest.fixture(scope="module")
def zero():
    """``torch_dist_helpers.zero_rank`` on three CPU workers, then on two
    of them, each a world of its own: n -> [each rank's results]."""
    tree = jax.tree.map(np.asarray, JaxGPT(JaxGPTConfig(**CFG)).init_params(
        jax.random.PRNGKey(3)))
    arrays = helpers.scaled_batches(CFG["vocab_size"], CFG["seq_len"], BATCH,
                                    STEPS, seed=5)
    payload = {"cfg": CFG, "tree": tree, "arrays": arrays, "batch": BATCH,
               "steps": STEPS}
    strategy = RayStrategy(num_workers=3, **WORKER)
    with _limit(LIMIT_S):
        strategy.setup()
        try:
            ranks = helpers.wire_worlds(strategy._workers, payload, LIMIT_S,
                                        fn=helpers.zero_rank)
        finally:
            strategy.teardown()
    return {"tree": tree, "arrays": arrays, "ranks": ranks}


def _jax_params(zero, zero_stage, root):
    m = JaxScaledGPT(JaxGPTConfig(**CFG))
    m.initial_params = zero["tree"]
    tr = JaxTrainer(strategy=JaxLocalStrategy(zero_stage=zero_stage),
                    max_steps=STEPS, limit_val_batches=0,
                    enable_checkpointing=False, default_root_dir=str(root))
    tr.fit(m, JaxArrays(zero["arrays"], BATCH))
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                tr.state.params)[0]}


def _diff(a, b):
    assert set(a) == set(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("stage", [1, 3])
def test_bucketed_step_equals_the_per_leaf_step(zero, n, stage):
    """Every rank's final params and moments: bitwise the per-leaf step's
    at two ranks, within 2e-6 at three; one collective a bucket."""
    for rank, out in enumerate(zero["ranks"][n]):
        got, ref = out[f"zero{stage}_bucketed"], out[f"zero{stage}_per_leaf"]
        for part in ("params", "opt"):
            if n == 2:
                for k in ref[part]:
                    np.testing.assert_array_equal(got[part][k],
                                                  ref[part][k], err_msg=k)
            else:
                assert _diff(got[part], ref[part]) < 2e-6
        buckets = out[f"zero{stage}_buckets"]
        # (At three ranks only qkv_w, 3·64 wide, divides.)
        assert (buckets["sharded"] < buckets["sharded_leaves"]
                or buckets["sharded_leaves"] == 1)
        assert buckets["replicated"] < buckets["replicated_leaves"]
        for c, p in zip(got["counts"], ref["counts"]):
            assert c["reduce_scatter"] == buckets["sharded"]
            # The replicated buckets, the clip's norm and the logs.
            assert c["all_reduce"] == buckets["replicated"] + 2
            assert c["all_gather"] == buckets["sharded"]
            assert p["reduce_scatter"] == buckets["sharded_leaves"]
            assert p["all_reduce"] == buckets["replicated_leaves"] + 2


@pytest.mark.parametrize("stage", [1, 3])
def test_bucketed_step_at_three_ranks_equals_jax(zero, stage, tmp_path):
    """The three-rank bucketed ZeRO step against the JAX package's fit of
    the same stage over the 8 CPU test devices: params within 2e-6; and
    the ranks hold the same full params bitwise."""
    want = _jax_params(zero, stage, tmp_path)
    ranks = zero["ranks"][3]
    got = ranks[0][f"zero{stage}_bucketed"]["params"]
    assert _diff(got, want) < 2e-6
    for out in ranks[1:]:
        other = out[f"zero{stage}_bucketed"]["params"]
        for k in got:
            np.testing.assert_array_equal(other[k], got[k])
