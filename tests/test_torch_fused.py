"""The port's fused PAOTA round held against the reference FusedPAOTA over
R rounds, with the reference's own draws handed to the port (ArrayDraws):
K = 8, make_mnist_like(n_train=2000), as tests/test_fused_round.py."""
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
from repro.fl import FLClient, FusedPAOTA, PAOTAConfig  # noqa: E402
from repro.models.mlp import init_mlp_params, mlp_loss  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
from repro_torch.data.pipeline import build_federation as tbuild  # noqa: E402
from repro_torch.models.mlp import mlp_loss as tloss  # noqa: E402
from repro_torch.models.mlp import params_from_jax  # noqa: E402

K = 8
R = 20

# global_vec: the reference's own fused-vs-host tolerance
# (tests/test_fused_round.py:55-57). In transmit='delta' the P2 powers are
# not capped by (7), so they carry the water-filling's sqrt(eps_f32)
# conditioning into the weights; the reference's own host server and
# fused scan drift apart as far (ROADMAP Queue 3, and
# test_reference_host_and_fused_drift_alike_in_delta_mode below).
TOL = {"model": dict(rtol=1e-4, atol=1e-5, varsigma=1e-5),
       "delta": dict(rtol=1e-4, atol=5e-5, varsigma=5e-4)}


@pytest.fixture(scope="module")
def data():
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    return x, y, partition_noniid(y, n_clients=K, seed=0)


def _jax_params():
    return init_mlp_params(jax.random.PRNGKey(0))


def _reference(data, transmit, **sched_kw):
    x, y, parts = data
    clients = [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for d in build_federation(x, y, parts)]
    sched = SchedulerConfig(n_clients=K, seed=1, **sched_kw)
    return FusedPAOTA(_jax_params(), clients, ChannelConfig(), sched,
                      PAOTAConfig(transmit=transmit)), sched


def _reference_draws(ref, sched, rounds):
    """The reference's draws for rounds 0..R (latencies, plans) and
    0..R-1 (channel, noise), as numpy arrays."""
    lat_key = jax.random.PRNGKey(sched.seed)
    srv = jax.random.PRNGKey(ref.cfg.seed)
    chan = ref.chan
    lat = [counter_latencies(lat_key, r, K, sched.lat_lo, sched.lat_hi)
           for r in range(rounds + 1)]
    ch = [sample_channel_gains(round_tag_key(srv, t, TAG_CHANNEL), K, chan)
          for t in range(rounds)]
    nz = [chan.sigma_n * jax.random.normal(round_tag_key(srv, t, TAG_NOISE),
                                           (ref.d,))
          for t in range(rounds)]
    plan = [ref.engine.round_plan(r) for r in range(rounds + 1)]
    return [np.stack([np.asarray(a) for a in arrs])
            for arrs in (lat, ch, nz, plan)]


def _port(data, transmit, draws=None, **sched_kw):
    x, y, parts = data
    clients = [tfl.FLClient(d, tloss, batch_size=32, lr=0.1, local_steps=5)
               for d in tbuild(x, y, parts)]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    _jax_params()))
    return tfl.FusedPAOTA(params, clients, tcore.ChannelConfig(),
                          tcore.SchedulerConfig(n_clients=K, seed=1,
                                                **sched_kw),
                          tfl.PAOTAConfig(transmit=transmit), device="cpu",
                          draws=draws)


def _pair(data, transmit, rounds=R, **sched_kw):
    ref, sched = _reference(data, transmit, **sched_kw)
    draws = tfl.ArrayDraws(*_reference_draws(ref, sched, rounds),
                           device="cpu")
    return ref, _port(data, transmit, draws, **sched_kw)


def _drift(tag, a_rows, b_rows, a_vec, b_vec):
    """Print how far two trajectories are apart (read with pytest -s)."""
    vs = max(abs(a["varsigma"] - b["varsigma"]) / max(b["varsigma"], 1e-30)
             for a, b in zip(a_rows, b_rows))
    print(f"\n{tag}: round {a_rows[-1]['round'] + 1}: max |w_g diff| "
          f"{np.abs(a_vec - b_vec).max():.3e}, max varsigma rel diff "
          f"{vs:.3e}")


def _assert_rows_track(port_rows, ref_rows, tol):
    assert [r["round"] for r in port_rows] == [r["round"] for r in ref_rows]
    for p, j in zip(port_rows, ref_rows):
        assert p["n_participants"] == j["n_participants"]
        assert p["time"] == j["time"]
        assert p["varsigma"] == pytest.approx(j["varsigma"],
                                              rel=tol["varsigma"])


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_slice_tracks_reference_over_5_then_20_rounds(data, transmit):
    ref, port = _pair(data, transmit)
    tol = TOL[transmit]
    for n in (5, R - 5):
        ref_rows, port_rows = ref.advance(n), port.advance(n)
        assert all(set(p) == set(j) for p, j in zip(port_rows, ref_rows))
        _drift(f"port vs reference, transmit={transmit}", port_rows,
               ref_rows, port.global_vec, ref.global_vec)
        _assert_rows_track(port_rows, ref_rows, tol)
        np.testing.assert_allclose(port.global_vec, ref.global_vec,
                                   rtol=tol["rtol"], atol=tol["atol"])
    rows = port.history
    assert any(r["n_participants"] > 0 for r in rows)
    assert any(r["mean_staleness"] > 0 for r in rows)      # semi-async
    assert rows[-1]["time"] == pytest.approx(R * 8.0)


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_zero_uploader_rounds_hold_global_bit_for_bit(data, transmit):
    """No client finishes before t = 30 s: three periods hold w_g exactly
    (and report varsigma 0), then uploads land and the port keeps tracking
    the reference (tests/test_fused_round.py:80-91)."""
    ref, port = _pair(data, transmit, rounds=6, delta_t=8.0, lat_lo=30.0,
                      lat_hi=40.0)
    g0 = port.global_vec.copy()
    rows = port.advance(3)
    ref.advance(3)
    assert all(r["n_participants"] == 0 for r in rows)
    assert all(r["varsigma"] == 0.0 for r in rows)
    assert all(r["p2_objective"] == float("inf") for r in rows)
    np.testing.assert_array_equal(port.global_vec, g0)
    np.testing.assert_array_equal(port.global_vec, ref.global_vec)
    rows, ref_rows = port.advance(3), ref.advance(3)
    assert any(r["n_participants"] > 0 for r in rows)
    assert not np.array_equal(port.global_vec, g0)
    _assert_rows_track(rows, ref_rows, TOL[transmit])
    np.testing.assert_allclose(port.global_vec, ref.global_vec,
                               rtol=TOL[transmit]["rtol"],
                               atol=TOL[transmit]["atol"])


def test_counter_draws_chunking_keeps_the_trajectory(data):
    """CounterDraws keys every draw on (seed, round, tag): advance(12) then
    advance(8) lands on the advance(20) trajectory bit for bit."""
    one = _port(data, "model")
    rows = one.advance(20)
    two = _port(data, "model")
    two.advance(12)
    two.advance(8)
    np.testing.assert_array_equal(one.global_vec, two.global_vec)
    assert rows == two.history
    assert np.isfinite(one.global_vec).all()
    assert any(r["n_participants"] > 0 for r in rows)


def test_reference_host_and_fused_drift_alike_in_delta_mode(data):
    """Why delta mode takes a wider tolerance: the reference's own host
    server and fused scan, on identical draws and in one framework, drift
    apart in transmit='delta' as far as the port does; both stay within
    the delta-mode tolerance."""
    from repro.fl import PAOTAServer
    x, y, parts = data
    clients = [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for d in build_federation(x, y, parts)]
    host = PAOTAServer(_jax_params(), clients, ChannelConfig(),
                       SchedulerConfig(n_clients=K, seed=1, rng="counter"),
                       PAOTAConfig(rng="counter", solver="waterfill_jnp",
                                   transmit="delta"))
    fused, _ = _reference(data, "delta")
    host_rows = [host.round() for _ in range(R)]
    fused_rows = fused.advance(R)
    _drift("reference host vs fused, transmit=delta", host_rows, fused_rows,
           host.global_vec, fused.global_vec)
    _assert_rows_track(host_rows, fused_rows, TOL["delta"])
    np.testing.assert_allclose(host.global_vec, fused.global_vec,
                               rtol=TOL["delta"]["rtol"],
                               atol=TOL["delta"]["atol"])


def test_cli_runs_on_cpu(capsys):
    from repro_torch.launch import fl_train
    fl_train.main(["--rounds", "3", "--clients", "4", "--device", "cpu",
                   "--transmit", "delta"])
    out = capsys.readouterr().out
    assert "K=4, d=8070, transmit=delta" in out
    assert "final acc" in out
    assert [ln.split()[:2] for ln in out.splitlines()
            if ln.split() and ln.split()[0] in ("0", "1", "2")] == [
        ["0", "8.0"], ["1", "16.0"], ["2", "24.0"]]
