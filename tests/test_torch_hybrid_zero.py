"""ZeRO over a ``data`` x ``fsdp`` mesh (hybrid sharding) on four CPU
ranks over gloo, held against the JAX package's ZeRO fit over the same
``{"data": 2, "fsdp": 2}`` mesh of CPU test devices.

Rank r sits where the JAX mesh puts device r (row-major over the axes in
their order), so it holds device r's batch rows.  The state is sharded
over each ``fsdp`` group (ranks {0, 1} and {2, 3}) and replicated along
``data`` (ranks {0, 2} hold the same slices, as do {1, 3}): a gradient is
reduce-scattered within the ``fsdp`` group and its slices all-reduced
across the ``data`` group, then divided by the four ranks.

Tolerances: losses within 2e-6 and params within 2e-6 of the JAX fit
(the strategies tests' bounds for the same f32 arithmetic summed in
another order: here a sum over two fsdp ranks, then two data ranks); a
restart checkpoint of the hybrid layout resumed on two ZeRO-3 ranks, and
one of two ranks resumed on the hybrid layout, within the same bounds of
the straight fits.
"""

import pytest
import torch

import torch_dist_helpers as helpers
import torch_multi_fits as mf
from ray_lightning_tpu_torch.parallel.strategies import (
    RayShardedStrategy, RayStrategy,
)

HYBRID = {"data": 2, "fsdp": 2}
BATCH, STEPS = 8, 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    strategy = RayStrategy(num_workers=4, **mf.WORKER)
    with mf.limit():
        strategy.setup()
    yield strategy
    strategy.teardown()


@pytest.fixture(scope="module")
def tree():
    return mf.init_tree(2)


@pytest.fixture(scope="module")
def data():
    return mf.batches(STEPS, BATCH, seed=17)


def _hybrid(pool, stage, **kw):
    return mf.on_pool(pool, RayShardedStrategy, 4, zero_stage=stage,
                      mesh_axes=HYBRID, **kw)


@pytest.mark.parametrize("stage", [1, 3])
def test_hybrid_zero_fit_matches_the_jax_hybrid_mesh(pool, tree, data, stage,
                                                     tmp_path):
    label = f"hybrid{stage}"
    tr = mf.port_fit(_hybrid(pool, stage), tree, data, BATCH,
                     tmp_path / "p", callbacks=[helpers.PlanProbe(label)])
    jx = mf.jax_fit(tree, data, BATCH, tmp_path / "j", HYBRID,
                    zero_stage=stage)
    assert tr.global_step == STEPS
    assert abs(tr.callback_metrics["train_loss"]
               - jx["metrics"]["train_loss"]) < 2e-6
    assert mf.max_diff(mf.port_by_path(tr.state.params), jx["params"]) \
        < 2e-6
    plans = helpers.RECORDS[label]
    assert [(plans[r]["rank"], plans[r]["world"], plans[r]["replicas"])
            for r in range(4)] == [(0, 2, 2), (1, 2, 2), (0, 2, 2),
                                   (1, 2, 2)]
    # Each slice's data replicas hold it bitwise; the fsdp peers differ.
    assert plans[0]["digest"] == plans[2]["digest"]
    assert plans[1]["digest"] == plans[3]["digest"]
    assert plans[0]["digest"] != plans[1]["digest"]


def _restart(strategy, tree, data, root, epochs, resume=None):
    return mf.port_fit(strategy, tree, data, BATCH, root, epochs=epochs,
                       limit_train_batches=1, restart_dir=str(root / "rs"),
                       restart_every_n_epochs=1,
                       resume_from_checkpoint=resume)


@pytest.mark.parametrize("direction", ["out_of_hybrid", "into_hybrid"])
def test_restart_checkpoints_into_and_out_of_the_hybrid_layout(
        pool, tree, data, direction, tmp_path):
    two = mf.on_pool(pool, RayShardedStrategy, 2, zero_stage=3)
    first, then = ((_hybrid(pool, 3), two) if direction == "out_of_hybrid"
                   else (two, _hybrid(pool, 3)))
    _restart(first, tree, data, tmp_path / "w", 1)
    ckpt = str(tmp_path / "w" / "rs" / "restart-epoch-000000.ckpt")
    probe = helpers.LoadStatsProbe(direction)
    resumed = mf.port_fit(then, tree, data, BATCH, tmp_path / "r", epochs=2,
                          limit_train_batches=1,
                          resume_from_checkpoint=ckpt, callbacks=[probe])
    straight = _restart(mf.on_pool(pool, RayShardedStrategy, 2,
                                   zero_stage=3),
                        tree, data, tmp_path / "s", 2)
    assert resumed.global_step == straight.global_step == 2
    assert abs(resumed.callback_metrics["train_loss"]
               - straight.callback_metrics["train_loss"]) < 2e-6
    assert mf.max_diff(mf.port_by_path(resumed.state.params),
                       mf.port_by_path(straight.state.params)) < 2e-6
    stats = helpers.RECORDS[direction]
    assert all(s["resumed"] for s in stats.values())
