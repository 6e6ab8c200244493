"""The multi-device fused CE island (``ops/cross_entropy.py::
fused_lm_head_cross_entropy_sharded``) on CPU ranks over gloo, held
against the JAX package's island (``test_sharded_island_parity``'s
arithmetic, ``tests/test_ops.py``: ``x (8, 64, 128)``, ``wte (515,
128)``, f32, a batch-sharded ``shard_map`` over a (2, 2, 2) mesh of CPU
devices, its kernels interpreted or its scan).

Each rank runs the fused CE on its rows against the whole vocabulary, on
its kernel route's plain version (``use_kernel``) or the scan, and takes
its share of the global mean; the backward's one collective is the
all-reduce of the ``dwte`` partials.  Tolerances: the global loss, each
rank's ``dx`` rows and ``dwte`` within 1e-5 of the JAX island's (the
JAX test's own bound against the naive head), at two and four ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dist_helpers as helpers
import torch_multi_fits as mf
from ray_lightning_tpu.ops.cross_entropy import (
    fused_lm_head_cross_entropy_sharded as jax_island,
)
from ray_lightning_tpu_torch.parallel.strategies import RayStrategy


def _inputs(V=515, B=8, T=64, d=128):
    kx, kw, kt = jax.random.split(jax.random.PRNGKey(7), 3)
    x = jax.random.normal(kx, (B, T, d), jnp.float32)
    wte = jax.random.normal(kw, (V, d), jnp.float32) * 0.1
    targets = jax.random.randint(kt, (B, T), 0, V)
    return x, wte, targets


@pytest.fixture(scope="module")
def jax_islands():
    x, wte, t = _inputs()
    mesh = Mesh(mesh_utils.create_device_mesh((2, 2, 2)),
                ("data", "fsdp", "tensor"))
    xs = jax.device_put(x, NamedSharding(mesh, P(("data", "fsdp"))))
    ts = jax.device_put(t, NamedSharding(mesh, P(("data", "fsdp"))))
    ws = jax.device_put(wte, NamedSharding(mesh, P()))
    out = {}
    for pallas in (True, False):
        def loss(x, w):
            return jax_island(x, w, ts, mesh, compute_dtype=jnp.float32,
                              use_pallas=pallas).mean()

        lv, (dx, dw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            xs, ws)
        out[pallas] = (float(lv), np.asarray(dx), np.asarray(dw))
    return {"inputs": tuple(np.asarray(a) for a in (x, wte, t)),
            "out": out}


@pytest.fixture(scope="module")
def islands(jax_islands):
    x, wte, t = jax_islands["inputs"]
    strategy = RayStrategy(num_workers=4, **mf.WORKER)
    with mf.limit():
        strategy.setup()
        try:
            return {kernel: helpers.wire_worlds(
                strategy._workers,
                {"x": x, "wte": wte, "targets": t.astype(np.int32),
                 "use_kernel": kernel}, mf.LIMIT_S, worlds=(2, 4),
                fn=helpers.island_rank) for kernel in (True, False)}
        finally:
            strategy.teardown()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel", [True, False])
def test_island_matches_the_jax_island(jax_islands, islands, kernel, n):
    loss, dx, dwte = jax_islands["out"][kernel]
    ranks = islands[kernel][n]
    rows = dx.shape[0] // n
    for r, out in enumerate(ranks):
        assert abs(out["loss"] - loss) < 1e-5
        np.testing.assert_allclose(out["dx"], dx[r * rows:(r + 1) * rows],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["dwte"], dwte, rtol=0, atol=1e-5)
        # The backward's one collective: the dwte partials' all-reduce.
        assert out["collectives"] == {"all_reduce": 1, "reduce_scatter": 0,
                                      "all_gather": 0}
    # Every rank holds the same summed dwte.
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["dwte"], ranks[0]["dwte"])
    assert abs(sum(o["share"] for o in ranks) - loss) < 1e-5


def test_island_refuses_a_batch_that_does_not_split(islands):
    for out in islands[True][2]:
        assert "batch dim 7 not divisible" in out["refused"]
    for out in islands[True][4]:
        assert "not divisible" in out["refused"]
