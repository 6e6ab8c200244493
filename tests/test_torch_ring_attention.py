"""Ring attention (``ray_lightning_tpu_torch/ops/ring_attention.py``) held
against the JAX package's ``ring_attention_sharded`` on the 8-device CPU
mesh (``{"sp": n}``), in both layouts: the in-process fold
(``ring_attention_local``) and the distributed ring on 2 and 4 CPU gloo
ranks (``torch_dist_helpers.ring_rank``: each rank's rows, the hop's
gradients coming back round the ring).

Bounds no looser than the JAX package's own for its ring
(``tests/test_ops.py``): the forward within 1e-5 and dq/dk/dv within 1e-4
max abs.  ``zigzag_indices`` equals JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_helpers as helpers
import torch_multi_fits as mf
from ray_lightning_tpu.ops import ring_attention as jax_ring
from ray_lightning_tpu_torch.ops import ring_attention as ring
from ray_lightning_tpu_torch.parallel.strategies import RayStrategy

SHAPE = (2, 32, 2, 8)  # B, S, H, D
LAYOUTS = ("contiguous", "zigzag")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(SHAPE).astype(np.float32)
            for k in ("q", "k", "v", "cot")}


def _jax_ring(x, n: int, layout: str):
    """JAX's forward and dq/dk/dv of ``sum(out · cot)`` over ``{"sp": n}``
    (one jitted vjp)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))

    def f(q, k, v):
        return jax_ring.ring_attention_sharded(
            q, k, v, mesh, seq_axis="sp", data_axis=None, layout=layout)

    @jax.jit
    def both(q, k, v, cot):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(cot)

    out, grads = both(*(jnp.asarray(x[n_]) for n_ in ("q", "k", "v",
                                                       "cot")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zigzag_indices_equal_jax(n):
    for seq in (2 * n, 8 * n, 48 * n):
        np.testing.assert_array_equal(ring.zigzag_indices(seq, n),
                                      jax_ring.zigzag_indices(seq, n))
    with pytest.raises(ValueError, match="divisible"):
        ring.zigzag_indices(2 * n + 1, n)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [2, 4])
def test_local_ring_matches_jax_ring(n, layout):
    x = _inputs(n)
    want, want_grads = _jax_ring(x, n, layout)
    q, k, v = (torch.from_numpy(x[k_]).requires_grad_(True)
               for k_ in ("q", "k", "v"))
    out = ring.ring_attention_local(q, k, v, n, layout)
    out.backward(torch.from_numpy(x["cot"]))
    assert np.abs(out.detach().numpy() - want).max() < 1e-5
    for got, g in zip((q.grad, k.grad, v.grad), want_grads):
        assert np.abs(got.numpy() - g).max() < 1e-4


@pytest.fixture(scope="module")
def pool():
    strategy = RayStrategy(num_workers=4, **mf.WORKER)
    with mf.limit():
        strategy.setup()
    yield strategy
    strategy.teardown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_distributed_ring_on_gloo_ranks_matches_jax(pool, layout):
    x = _inputs(11)
    with mf.limit():
        results = helpers.wire_worlds(pool._workers, {**x, "layout": layout},
                                      timeout=120, worlds=(2, 4),
                                      fn=helpers.ring_rank)
    for n, ranks in results.items():
        want, want_grads = _jax_ring(x, n, layout)
        out = np.zeros(SHAPE, np.float32)
        grads = [np.zeros(SHAPE, np.float32) for _ in range(3)]
        for r in ranks:
            out[:, r["rows"]] = r["out"]
            for g, name in zip(grads, ("dq", "dk", "dv")):
                g[:, r["rows"]] = r[name]
        assert np.abs(out - want).max() < 1e-5, n
        for got, g in zip(grads, want_grads):
            assert np.abs(got - g).max() < 1e-4, n


def test_hop_route_follows_the_backend(monkeypatch):
    """The hop's route is the group's backend's (and under gloo the
    tensor's device), never a fallback; another backend raises."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.parallel.model_parallel import AxisGroup

    g = AxisGroup(None, 0, 2, (0, 1))
    cpu = torch.zeros(2)
    for backend, want in (("nccl", "nccl"), ("gloo", "gloo")):
        monkeypatch.setattr(dist, "get_backend", lambda group=None,
                            b=backend: b)
        assert ring.hop_route(g, cpu) == want
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "mpi")
    with pytest.raises(NotImplementedError, match="no route"):
        ring.hop_route(g, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        ring.ring_attention_local(*(torch.zeros(SHAPE),) * 3, 2, "striped")
