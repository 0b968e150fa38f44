"""Port data, model and batched local SGD held against the reference:
the numpy data copies bit for bit, the MLP and its ravel order, and M
local SGD steps for all K clients from the same params and plan."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.data import partition as jpart  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.fl.client import FLClient as JClient  # noqa: E402
from repro.fl.engine import BatchedEngine as JEngine  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.core.aggregation import ravel  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.fl.client import FLClient as TClient  # noqa: E402
from repro_torch.fl.engine import BatchedEngine as TEngine  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

K = 8


@pytest.fixture(scope="module")
def data():
    return jsyn.make_mnist_like(n_train=2000, n_test=200)


def _np_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp_params(jax.random.PRNGKey(seed)))


def test_synthetic_data_is_the_reference_bit_for_bit(data):
    for want, got in zip(data, tsyn.make_mnist_like(n_train=2000,
                                                    n_test=200)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes", [tpart.PAPER_SIZES, tpart.FAST_SIZES])
def test_partition_and_stacking_are_the_reference(data, sizes):
    assert tpart.PAPER_SIZES == jpart.PAPER_SIZES
    assert tpart.FAST_SIZES == jpart.FAST_SIZES
    x, y = data[0], data[1]
    pj = jpart.partition_noniid(y, n_clients=K, sizes=sizes, seed=3)
    pt = tpart.partition_noniid(y, n_clients=K, sizes=sizes, seed=3)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(a, b)
    sj = jpipe.stack_federation(jpipe.build_federation(x, y, pj))
    st = tpipe.stack_federation(tpipe.build_federation(x, y, pt))
    np.testing.assert_array_equal(st.x, sj.x)
    np.testing.assert_array_equal(st.y, sj.y)
    np.testing.assert_array_equal(st.n_samples, sj.n_samples)


def test_ravel_order_and_params_from_jax():
    """JAX ravels a dict in sorted key order: l1.b, l1.w, l2.b, l2.w, l3.b,
    l3.w — biases first. The port's ravel must give the same vector."""
    jp = jmlp.init_mlp_params(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype).reshape(
            a.shape), jp)          # non-zero biases, so order is visible
    want, _ = ravel_pytree(jp)
    tp = tmlp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    vec, unravel = ravel(tp)
    assert vec.shape == (8070,) and vec.dtype == torch.float32
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vec[:10].numpy(),
                                  np.asarray(jp["l1"]["b"]))
    back = unravel(vec)
    for layer in ("l1", "l2", "l3"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[layer][leaf].numpy(),
                                          np.asarray(jp[layer][leaf]))
    # stacked unravel: (K, d) -> (K, ...) leaves
    stacked = unravel(vec.expand(3, -1))
    assert stacked["l1"]["w"].shape == (3, 784, 10)


def test_mlp_matches_reference(data):
    x, y = data[0][:64], data[1][:64]
    npp = _np_params(1)
    tp = tmlp.params_from_jax(npp)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    np.testing.assert_allclose(tmlp.mlp_apply(tp, tb["x"]).numpy(),
                               np.asarray(jmlp.mlp_apply(npp, jb["x"])),
                               rtol=1e-5, atol=1e-5)
    assert float(tmlp.mlp_loss(tp, tb)) == pytest.approx(
        float(jmlp.mlp_loss(npp, jb)), rel=1e-6)
    assert float(tmlp.mlp_accuracy(tp, tb)) == float(
        jmlp.mlp_accuracy(npp, jb))


def test_local_sgd_matches_reference_engine(data):
    """M = 5 local SGD steps for all K clients from the same carried-over
    params and the same (K, M, B) plan: rtol 1e-5, atol 1e-6."""
    x, y = data[0], data[1]
    parts = jpart.partition_noniid(y, n_clients=K, seed=0)
    je = JEngine.from_clients([JClient(d, jmlp.mlp_loss, 32, 0.1, 5)
                               for d in jpipe.build_federation(x, y, parts)])
    te = TEngine.from_clients([TClient(d, tmlp.mlp_loss, 32, 0.1, 5)
                               for d in tpipe.build_federation(x, y, parts)],
                              device="cpu")
    je.enable_counter_plan(jax.random.PRNGKey(0))
    npp = _np_params(2)
    for r in (0, 7):
        plan = np.array(je.round_plan(r))
        want = np.asarray(je._train_all(npp, je._x, je._y,
                                        jnp.asarray(plan)))
        got = te.train_all(tmlp.params_from_jax(npp),
                           torch.from_numpy(plan).long())
        assert got.shape == (K, 8070)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_counter_batch_plan_bounds_and_keying():
    n = torch.tensor([3, 40, 1, 1500])
    a = tpipe.counter_batch_plan(4, 2, n, 5, 32)
    assert a.shape == (4, 5, 32) and a.dtype == torch.int64
    assert bool((a >= 0).all()) and bool((a < n[:, None, None]).all())
    assert bool((a[2] == 0).all())                  # n_k = 1: one sample
    torch.testing.assert_close(tpipe.counter_batch_plan(4, 2, n, 5, 32), a,
                               rtol=0, atol=0)
    assert not torch.equal(tpipe.counter_batch_plan(4, 3, n, 5, 32), a)
