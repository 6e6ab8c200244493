"""int8 AdamW moments under ZeRO (``RayShardedStrategy`` stage 1 and 3,
and the sharded weight update), held against the one-device update and
against the JAX package, on CPU ranks over gloo.

The state's layout is the JAX package's: a ``BlockQuantized`` moment's
flat payload ``q`` and its ``scale`` have no param twin, so each shards
along dim 0 where its length divides the world and reaches 2^12, else
stays replicated.  A rank updates its run of the flat padded gradient,
param and moments; a block its run's ends cut in two (two ranks, an odd
block count) takes its absmax from both (one MAX all-reduce).

Tolerances.  The sharded update against the whole update on the same
state and gradients (:func:`test_sharded_update_is_bitwise_the_whole_one`):
bitwise, params and moments, at two (blocks straddling), three (a
payload that does not divide, updated whole) and four ranks.  Fits
against the JAX package's ZeRO fit of the same stage over the matching
``data`` mesh: loss within 1e-5, params within 1e-4 everywhere and 1e-5
at all but 0.5% of a leaf's elements (``tests/test_torch_opt_state.py``'s
int8 bounds: a gradient ~1e-7 apart puts an element on a payload's
rounding boundary on the neighbouring step).  The sharded update at
full width against the replicated update of the same two ranks (JAX pins
``fit("on") == fit("off")`` with the int8_ef wire): loss within 1e-6 and
params within 1e-5, the clip's norm being summed a slice at a time.
"""

import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
import torch_multi_fits as mf
from ray_lightning_tpu.utils import sharded_ckpt as jax_sc
from ray_lightning_tpu_torch.parallel.strategies import (
    RayShardedStrategy, RayStrategy,
)
from ray_lightning_tpu_torch.utils import sharded_ckpt

INT8 = {"opt_state_dtype": "int8"}
# (33, 128): 33 blocks, so two and four ranks cut one (payload runs of
# 16.5 and 8.25 blocks) and the param shards along dim 1; (96, 50): a
# payload of 38 blocks that three ranks cannot divide (updated whole
# while the param shards along dim 0); (1024, 512): 4096 blocks, whose
# scale shards too; (40, 64): under 2^12, f32 moments.
SHAPES = [(33, 128), (96, 50), (1024, 512), (40, 64)]
BATCH, STEPS = 12, 3


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
def updates(pool):
    with mf.limit():
        return helpers.wire_worlds(pool._workers, {"shapes": SHAPES,
                                                   "seed": 3},
                                   mf.LIMIT_S, worlds=(2, 3, 4),
                                   fn=helpers.int8_zero_rank)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_update_is_bitwise_the_whole_one(updates, n):
    ranks = updates[n]
    for out in ranks:
        for part in ("params", "opt"):
            want, got = out["whole"][part], out["zero"][part]
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    out = ranks[0]
    # The layouts the cases were chosen for.
    assert out["flat"][:3] == [True, n != 3, n != 3]
    assert out["udims"][1] == (None if n == 3 else 0)
    assert out["dims"][0] == (0 if n == 3 else 1)
    assert out["dims"][1] == 0
    starts = {v[0] for r in ranks for k, v in r["runs"].items()
              if "p0_w" in k}
    if n in (2, 4):
        assert any(s % 128 for s in starts)  # a block cut by two ranks
    # The 4096-block scale shards over 2 and 4 ranks (three cannot
    # divide its payload: no run).
    big = [v for k, v in ranks[0]["runs"].items() if "p2_w" in k]
    assert len(big) == (0 if n == 3 else 2) and all(v[2] for v in big)


@pytest.fixture(scope="module")
def tree():
    return mf.init_tree(0)


@pytest.fixture(scope="module")
def data():
    return mf.batches(STEPS, BATCH, seed=21)


def _int8_bounds(got, want):
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert float(diff.max()) < 1e-4, k
        assert float((diff >= 1e-5).mean()) <= 5e-3, k


@pytest.mark.parametrize("n,stage", [(2, 1), (2, 3), (3, 1), (3, 3)])
def test_int8_zero_fit_matches_the_jax_zero_fit(pool, tree, data, n, stage,
                                                tmp_path):
    tr = mf.port_fit(mf.on_pool(pool, RayShardedStrategy, n,
                                zero_stage=stage),
                     tree, data, BATCH, tmp_path / "p", cfg=INT8)
    jx = mf.jax_fit(tree, data, BATCH, tmp_path / "j", {"data": n},
                    zero_stage=stage, cfg=INT8)
    assert tr.global_step == STEPS
    assert abs(tr.callback_metrics["train_loss"]
               - jx["metrics"]["train_loss"]) < 1e-5
    _int8_bounds(mf.port_by_path(tr.state.params), jx["params"])
    # The adopted state is whole: each moment's payload its full length.
    adam = tr.state.opt_state[1]
    assert adam["mu"]["wte"].shard is None
    assert adam["mu"]["wte"].q.numel() == jx["state"].opt_state[1][0] \
        .mu["wte"].q.size


def test_sharded_update_with_int8_moments_and_wire(pool, tree, data,
                                                   tmp_path):
    def fit(us):
        return mf.port_fit(mf.on_pool(pool, RayStrategy, 2,
                                      update_sharding=us,
                                      grad_comm="int8_ef"),
                           tree, data, BATCH, tmp_path / us, cfg=INT8)

    on, off = fit("on"), fit("off")
    assert on.telemetry_report["meta"]["update_sharding"] == "on"
    assert on.comm_stats["grad_sync_mode"] == "int8_ef"
    assert abs(on.callback_metrics["train_loss"]
               - off.callback_metrics["train_loss"]) < 1e-6
    assert mf.max_diff(mf.port_by_path(on.state.params),
                       mf.port_by_path(off.state.params)) < 1e-5


def _restart_fit(strategy_or_jax, tree, data, root, n, stage, epochs,
                 resume=None):
    """Epochs of one batch each (a restart checkpoint a epoch)."""
    if strategy_or_jax == "jax":
        return mf.jax_fit(tree, data, BATCH, root, {"data": n},
                          zero_stage=stage, cfg=INT8, max_epochs=epochs,
                          limit_train_batches=1,
                          restart_dir=str(root / "rs"),
                          restart_every_n_epochs=1,
                          resume_from_checkpoint=resume)
    return mf.port_fit(strategy_or_jax, tree, data, BATCH, root, cfg=INT8,
                       epochs=epochs, limit_train_batches=1,
                       restart_dir=str(root / "rs"),
                       restart_every_n_epochs=1,
                       resume_from_checkpoint=resume)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_int8_sharded_checkpoint_reads_across_packages(pool, tree, data,
                                                       writer, tmp_path):
    """An RLTSHRD2 directory of a two-rank int8 ZeRO-1 fit written by one
    package and resumed by the other for a second epoch, against the
    writer's own straight two-epoch fit: the int8 bounds."""
    if writer == "port":
        _restart_fit(mf.on_pool(pool, RayShardedStrategy, 2, zero_stage=1),
                     tree, data, tmp_path / "w", 2, 1, 1)
    else:
        _restart_fit("jax", tree, data, tmp_path / "w", 2, 1, 1)
    ckpt = str(tmp_path / "w" / "rs" / "restart-epoch-000000.ckpt")
    assert sharded_ckpt.is_sharded_ckpt(ckpt)
    if writer == "port":
        resumed = _restart_fit("jax", tree, data, tmp_path / "r", 2, 1, 2,
                               resume=ckpt)
        got = resumed["params"]
        straight = _restart_fit(mf.on_pool(pool, RayShardedStrategy, 2,
                                           zero_stage=1),
                                tree, data, tmp_path / "s", 2, 1, 2)
        want = mf.port_by_path(straight.state.params)
    else:
        resumed = _restart_fit(mf.on_pool(pool, RayShardedStrategy, 2,
                                          zero_stage=1),
                               tree, data, tmp_path / "r", 2, 1, 2,
                               resume=ckpt)
        assert resumed.global_step == 2
        got = mf.port_by_path(resumed.state.params)
        want = _restart_fit("jax", tree, data, tmp_path / "s", 2, 1,
                            2)["params"]
    _int8_bounds(got, want)


def test_int8_zero_resume_four_to_two_reads_selectively(pool, tree, data,
                                                        tmp_path):
    """A four-rank int8 ZeRO-3 restart checkpoint resumed on two ranks:
    each rank reads only its runs of the payloads and scales (the
    selective reader), and the second epoch lands bitwise on the
    uninterrupted two-epoch four-rank fit's losses' bounds."""
    four = mf.on_pool(pool, RayShardedStrategy, 4, zero_stage=3)
    _restart_fit(four, tree, data, tmp_path / "w", 4, 3, 1)
    ckpt = str(tmp_path / "w" / "rs" / "restart-epoch-000000.ckpt")
    probe = helpers.LoadStatsProbe("int8_4to2")
    two = mf.on_pool(pool, RayShardedStrategy, 2, zero_stage=3)
    resumed = mf.port_fit(two, tree, data, BATCH, tmp_path / "r", cfg=INT8,
                          epochs=2, limit_train_batches=1,
                          resume_from_checkpoint=ckpt, callbacks=[probe])
    stats = helpers.RECORDS["int8_4to2"]
    assert sorted(stats) == [0, 1]
    assert all(s["load_stats"]["selective"] for s in stats.values())
    straight = _restart_fit(mf.on_pool(pool, RayShardedStrategy, 4,
                                       zero_stage=3),
                            tree, data, tmp_path / "s", 4, 3, 2)
    assert resumed.global_step == straight.global_step == 2
    _int8_bounds(mf.port_by_path(resumed.state.params),
                 mf.port_by_path(straight.state.params))
    # The four-rank directory read by the JAX reader too, whole.
    whole = jax_sc.load_sharded(ckpt)
    assert whole["world_size"] == 4
