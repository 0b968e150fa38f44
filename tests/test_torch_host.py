"""The port's host-path PAOTAServer held against the reference PAOTAServer
over 5 rounds on the same inputs and draws: K = 8,
make_mnist_like(n_train=2000), as tests/test_fused_round.py.

Counter mode hands the reference's keyed draws to the port (ArrayDraws);
host mode keeps the numpy streams (PCG64 latencies, epoch-cursor plans),
which are bit-equal by construction, and replays the reference's split
chain of channel and noise keys, indexed by aggregating round."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ChannelConfig, SchedulerConfig  # noqa: E402
from repro.core.aircomp import sample_channel_gains  # noqa: E402
from repro.core.scheduler import (TAG_CHANNEL, TAG_NOISE,  # noqa: E402
                                  counter_latencies, round_tag_key)
from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.pipeline import build_federation  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro.fl import FLClient, PAOTAConfig, PAOTAServer  # noqa: E402
from repro.models.mlp import init_mlp_params, mlp_loss  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
from repro_torch.data.pipeline import build_federation as tbuild  # noqa: E402
from repro_torch.kernels import aircomp_sum as tac  # noqa: E402
from repro_torch.models.mlp import mlp_loss as tloss  # noqa: E402
from repro_torch.models.mlp import params_from_jax  # noqa: E402

K = 8
R = 5

# the reference's own fused-vs-host tolerance (tests/test_fused_round.py),
# in both transmit modes: the host solvers work in f64, so the f32
# water-filling's flat-objective spread (ROADMAP Queue 3) does not arise
TOL = dict(rtol=1e-4, atol=1e-5, varsigma=1e-5)


@pytest.fixture(scope="module")
def data():
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    return x, y, partition_noniid(y, n_clients=K, seed=0)


def _jax_params():
    return init_mlp_params(jax.random.PRNGKey(0))


def _reference(data, cfg, **sched_kw):
    x, y, parts = data
    clients = [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for d in build_federation(x, y, parts)]
    sched = SchedulerConfig(n_clients=K, seed=1, **sched_kw)
    return PAOTAServer(_jax_params(), clients, ChannelConfig(), sched, cfg)


def _port(data, cfg, draws, **sched_kw):
    x, y, parts = data
    clients = [tfl.FLClient(d, tloss, batch_size=32, lr=0.1, local_steps=5)
               for d in tbuild(x, y, parts)]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    _jax_params()),
                             device="cpu")
    return tfl.PAOTAServer(params, clients, tcore.ChannelConfig(),
                           tcore.SchedulerConfig(n_clients=K, seed=1,
                                                 **sched_kw),
                           tfl.PAOTAConfig(**cfg.__dict__), device="cpu",
                           draws=draws)


def _counter_draws(ref, rounds):
    """The reference's keyed draws: latencies and plans for broadcast
    rounds 0..R, channel and noise for aggregation rounds 0..R-1."""
    lat_key = jax.random.PRNGKey(ref.scheduler.cfg.seed)
    srv = jax.random.PRNGKey(ref.cfg.seed)
    chan = ref.chan
    lat = [counter_latencies(lat_key, r, K, ref.scheduler.cfg.lat_lo,
                             ref.scheduler.cfg.lat_hi)
           for r in range(rounds + 1)]
    ch = [sample_channel_gains(round_tag_key(srv, t, TAG_CHANNEL), K, chan)
          for t in range(rounds)]
    nz = [chan.sigma_n * jax.random.normal(round_tag_key(srv, t, TAG_NOISE),
                                           (ref.d,))
          for t in range(rounds)]
    plan = [ref.engine.round_plan(r) for r in range(rounds + 1)]
    return tfl.ArrayDraws(*[np.stack([np.asarray(a) for a in arrs])
                            for arrs in (lat, ch, nz, plan)], device="cpu")


def _split_chain_draws(seed, chan, d, n):
    """The reference's host-mode draws: for the i-th aggregating round, the
    channel key is split off first, then the noise key."""
    key = jax.random.PRNGKey(seed)
    ch, nz = [], []
    for _ in range(n):
        key, sub = jax.random.split(key)
        ch.append(np.asarray(sample_channel_gains(sub, K, chan)))
        key, sub = jax.random.split(key)
        nz.append(np.asarray(chan.sigma_n * jax.random.normal(
            sub, (d,), np.float32)))
    return tfl.ArrayDraws(channel=np.stack(ch), noise=np.stack(nz),
                          device="cpu")


def _assert_tracks(port, ref, tol, rounds=R):
    for _ in range(rounds):
        p, j = port.round(), ref.round()
        assert set(p) == set(j)
        assert (p["round"], p["n_participants"], p["time"]) == (
            j["round"], j["n_participants"], j["time"])
        assert p["mean_staleness"] == j["mean_staleness"]
        assert p["varsigma"] == pytest.approx(j["varsigma"],
                                              rel=tol["varsigma"])
        np.testing.assert_allclose(port.global_vec, ref.global_vec,
                                   rtol=tol["rtol"], atol=tol["atol"])
    np.testing.assert_allclose(port.prev_global, ref.prev_global,
                               rtol=tol["rtol"], atol=tol["atol"])
    return port.history


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_counter_mode_tracks_reference_with_and_without_kernel(data,
                                                                transmit):
    """rng='counter': the reference (its aircomp_sum Pallas kernel in
    interpret mode) against the port on both aggregation routes."""
    cfg = PAOTAConfig(rng="counter", transmit=transmit, use_kernel=True)
    ref = _reference(data, cfg, rng="counter")
    draws = _counter_draws(ref, R)
    ref_rows = [ref.round() for _ in range(R)]
    for use_kernel in (True, False):
        port = _port(data, PAOTAConfig(rng="counter", transmit=transmit,
                                       use_kernel=use_kernel), draws,
                     rng="counter")
        before = tac.aircomp_sum_launches
        rows = [port.round() for _ in range(R)]
        assert tac.aircomp_sum_launches == before    # CPU: the twin ran
        for p, j in zip(rows, ref_rows):
            assert (p["n_participants"], p["time"]) == (
                j["n_participants"], j["time"])
            assert p["varsigma"] == pytest.approx(
                j["varsigma"], rel=TOL["varsigma"])
        np.testing.assert_allclose(port.global_vec, ref.global_vec,
                                   rtol=TOL["rtol"], atol=TOL["atol"])
    assert any(r["n_participants"] > 0 for r in ref_rows)


def test_host_mode_waterfill_across_a_zero_uploader_period(data):
    """rng='host', solver='waterfill': no client finishes before t = 20 s,
    so rounds 0 and 1 hold w_g and consume no draws; the split chain then
    feeds the aggregating rounds in order."""
    cfg = PAOTAConfig(solver="waterfill")
    ref = _reference(data, cfg, lat_lo=20.0, lat_hi=30.0)
    draws = _split_chain_draws(cfg.seed, ref.chan, ref.d, R)
    port = _port(data, cfg, draws, lat_lo=20.0, lat_hi=30.0)
    g0 = port.global_vec.copy()
    rows = _assert_tracks(port, ref, TOL)
    assert [r["n_participants"] for r in rows[:2]] == [0, 0]
    assert [r["varsigma"] for r in rows[:2]] == [0.0, 0.0]
    assert rows[2]["n_participants"] > 0
    assert not np.array_equal(port.global_vec, g0)


def test_host_mode_pgd_solver(data):
    cfg = PAOTAConfig(solver="pgd")
    ref = _reference(data, cfg)
    draws = _split_chain_draws(cfg.seed, ref.chan, ref.d, R)
    port = _port(data, cfg, draws)
    rows = _assert_tracks(port, ref, TOL)
    for p, j in zip(rows, ref.history):
        assert p["beta_mean"] == pytest.approx(j["beta_mean"], rel=1e-4,
                                               abs=1e-6)


def test_host_server_hygiene(data):
    x, y, parts = data
    clients = [tfl.FLClient(d, tloss, 32, 0.1, 5)
               for d in tbuild(x, y, parts)]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    _jax_params()),
                             device="cpu")

    def make(cfg, **kw):
        return tfl.PAOTAServer(params, clients, tcore.ChannelConfig(),
                               tcore.SchedulerConfig(n_clients=K, **kw), cfg,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="legacy"):
        make(tfl.PAOTAConfig(engine="legacy"))
    with pytest.raises(ValueError, match="solver"):
        make(tfl.PAOTAConfig(solver="cplex"))
    with pytest.raises(ValueError, match="counter"):
        make(tfl.PAOTAConfig(rng="counter"))
    with pytest.raises(ValueError, match="scenario simulation needs counter"):
        tcore.SemiAsyncScheduler(tcore.SchedulerConfig(),
                                 scenario=tcore.ScenarioConfig())
    srv = make(tfl.PAOTAConfig(rng="counter", solver="waterfill_jnp"),
               rng="counter")
    assert srv.round()["round"] == 0
