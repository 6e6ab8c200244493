"""Megastep under a strategy's process group (``parallel/step_fns.py::
MultiStep`` over a rank's ``DistributedStep``), and the rules that
decide it and the sharded update on the card, held against the JAX
package's megastep on a CPU mesh.

On CPU workers a stride of K steps runs eagerly, as the JAX package's
megastep runs on a CPU mesh; on the card over NCCL it is captured with
its collectives into one CUDA graph (``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 18, one-rank NCCL worlds).  Here, on two gloo
ranks: K = 4 is bitwise the port's own K = 1 fit (params and every
step's loss), for ``RayStrategy``, ``RayShardedStrategy(zero_stage=3)``
and the int8_ef wire (its residual threaded through the stride), and
against the JAX package's K = 4 fit on a 2-device ``data`` mesh: loss
within 2e-6 and params within 2e-6 at full width (the strategies tests'
bounds: the same f32 arithmetic in another order), within 1% of the loss
and 1e-3 of the params for int8_ef (the wire's bounds against full
width, ``tests/test_torch_grad_comm.py``: a gradient ~1e-7 apart can
put a payload element on the neighbouring step).
"""

import numpy as np
import pytest
import torch

import torch_multi_fits as mf
from ray_lightning_tpu.core import loop as jax_loop
from ray_lightning_tpu_torch.core.loop import (
    FitConfig, _resolve_megastep, _resolve_update_sharding,
)
from ray_lightning_tpu_torch.parallel.strategies import (
    RayShardedStrategy, RayStrategy,
)

BATCH, STEPS = 8, 8
FLAVORS = {
    "ray": (RayStrategy, {}, 0, None),
    "zero3": (RayShardedStrategy, {"zero_stage": 3}, 3, None),
    "int8_ef": (RayStrategy, {"grad_comm": "int8_ef"}, 0,
                {"mode": "int8_ef", "dcn_only": False}),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    strategy = RayStrategy(num_workers=2, **mf.WORKER)
    with mf.limit():
        strategy.setup()
    yield strategy
    strategy.teardown()


@pytest.fixture(scope="module")
def tree():
    return mf.init_tree(1)


@pytest.fixture(scope="module")
def data():
    return mf.batches(STEPS, BATCH, seed=13)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_two_rank_megastep_equals_k1_and_the_jax_megastep(
        pool, tree, data, flavor, tmp_path):
    cls, kw, zero, jax_comm = FLAVORS[flavor]

    def fit(k):
        return mf.port_fit(mf.on_pool(pool, cls, 2, **kw), tree, data,
                           BATCH, tmp_path / str(k), megastep=k)

    four, one = fit(4), fit("off")
    assert four.telemetry_report["meta"]["megastep"] == 4
    assert one.telemetry_report["meta"]["megastep"] == 1
    assert four.global_step == one.global_step == STEPS
    got, ref = mf.port_by_path(four.state.params), mf.port_by_path(
        one.state.params)
    assert mf.bitwise(got, ref)
    assert mf.bitwise(mf.port_by_path(four.state.opt_state),
                      mf.port_by_path(one.state.opt_state))
    # The strides' last losses are the single steps' at the same steps.
    assert mf.losses(four) == mf.losses(one)[3::4]
    jx = mf.jax_fit(tree, data, BATCH, tmp_path / "jax", {"data": 2},
                    zero_stage=zero, grad_comm=jax_comm, megastep=4)
    want = jx["metrics"]["train_loss"]
    loss = four.callback_metrics["train_loss"]
    if jax_comm is None:
        assert abs(loss - want) < 2e-6
        assert mf.max_diff(got, jx["params"]) < 2e-6
    else:
        assert four.comm_stats["grad_sync_mode"] == "int8_ef"
        assert abs(loss - want) <= 0.01 * abs(want)
        assert mf.max_diff(got, jx["params"]) < 1e-3


def test_megastep_resolves_as_jax_on_cpu_workers(monkeypatch):
    """On CPU workers every knob resolves as the JAX package resolves it
    on a CPU mesh (auto 1, K taken, off 1)."""
    cpu = torch.device("cpu")
    for value in ("auto", "off", 1, 4, 8):
        assert _resolve_megastep(FitConfig(megastep=value), cpu, "gloo") \
            == jax_loop._resolve_megastep(jax_loop.FitConfig(
                megastep=value))
    monkeypatch.setenv("RLT_MEGASTEP", "4")
    assert _resolve_megastep(FitConfig(), cpu, "gloo") == 4


def test_update_sharding_auto_is_off_over_gloo_on_the_card():
    """Auto shards the update on the card over NCCL (the JAX accelerator
    rule) and not over gloo, where a traced step showed gloo's own
    collectives to cost it (PERF.md §5); "on" still takes it there."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    auto, on = FitConfig(update_sharding="auto"), FitConfig(
        update_sharding="on")
    assert _resolve_update_sharding(auto, 2, "gspmd", 0, cuda, None, "nccl")
    assert not _resolve_update_sharding(auto, 2, "gspmd", 0, cuda, None,
                                        "gloo")
    assert not _resolve_update_sharding(auto, 2, "gspmd", 0, cpu, None,
                                        "gloo")
    assert _resolve_update_sharding(on, 2, "gspmd", 0, cuda, None, "gloo")
    assert not _resolve_update_sharding(auto, 1, "gspmd", 0, cuda, None,
                                        "nccl")


def test_megastep_over_gloo_on_the_card_raises_before_the_fit():
    """K > 1 on card workers over gloo raises, naming gloo's collectives
    (they cannot be captured); nothing falls back to eager steps."""
    with pytest.raises(NotImplementedError, match="gloo"):
        _resolve_megastep(FitConfig(megastep=8), torch.device("cuda", 0),
                          "gloo")
