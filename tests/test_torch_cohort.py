"""The port's active-cohort round held against the reference
FusedPAOTA(cohort_size=m) over R rounds, with the reference's own draws
handed to the port (ArrayDraws): K = 12 clients, m = 4 slots,
make_mnist_like(n_train=2000), both transmit modes, with and without the
cycle + dropout + lognormal + het_steps scenario. Also the m = K cohort
against the port's dense round, the slot-turnover scatters with duplicate
occupant ids, and FusedPAOTA's validation.

The helpers here (``pair``, ``step_pair``) are shared with
tests/test_torch_compress.py and tests/test_torch_scenario.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ChannelConfig, SchedulerConfig  # noqa: E402
from repro.core.scheduler import ScenarioConfig  # noqa: E402
from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.pipeline import build_federation  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro.fl import FLClient, FusedPAOTA, PAOTAConfig  # noqa: E402
from repro.models.mlp import init_mlp_params, mlp_loss  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
from repro_torch.core.scheduler import ScenarioTraits  # noqa: E402
from repro_torch.data.pipeline import build_federation as tbuild  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.models.mlp import mlp_loss as tloss  # noqa: E402
from repro_torch.models.mlp import params_from_jax  # noqa: E402

K = 12
M = 4
R = 20
# the reference's own fused-vs-host tolerance (tests/test_fused_round.py);
# transmit='delta' takes the fused round's filed tolerance (ROADMAP Queue 3
# item 1, tests/test_torch_fused.py TOL["delta"]): the cohort runs the same
# water-filling on the same delta plane
TOL = {"model": dict(rtol=1e-4, atol=1e-5, varsigma=1e-5),
       "delta": dict(rtol=1e-4, atol=5e-5, varsigma=5e-4)}
STATE = ("slot_client", "slot_live", "ready", "model_round")
SCENARIO = dict(availability="cycle", avail_period=4, avail_duty=0.5,
                dropout_prob=0.1, responsiveness="lognormal",
                het_steps=(1, 3, 5))


@pytest.fixture(scope="module")
def data():
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    return x, y, partition_noniid(y, n_clients=K, seed=0)


def _jax_params():
    return init_mlp_params(jax.random.PRNGKey(0))


def reference(data, transmit, scenario=None, k=K, chan=None, **kw):
    x, y, parts = data
    clients = [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for d in build_federation(x, y, parts)]
    sc = None if scenario is None else ScenarioConfig(**scenario)
    return FusedPAOTA(_jax_params(), clients, ChannelConfig(**(chan or {})),
                      SchedulerConfig(n_clients=k, seed=1),
                      PAOTAConfig(transmit=transmit), scenario=sc, **kw)


def reference_draws(ref, rounds):
    """Every draw the reference's round consumes, as ArrayDraws arguments:
    its own stream callbacks evaluated round by round (latencies through
    the scenario's responsiveness model, the int8 dither as the uniforms
    its key gives), and its engine's static traits."""
    st = ref._streams()
    sig = ref.chan.sigma_n
    out = {"latencies": [st.latencies(r) for r in range(rounds + 1)],
           "channel": [st.channel(t) for t in range(rounds)],
           "noise": [sig * jax.random.normal(st.noise_key(t), (ref.d,))
                     for t in range(rounds)],
           "batch_plan": [ref.engine.round_plan(r)
                          for r in range(rounds + 1)]}
    if st.sched_priority is not None:
        out["priority"] = [st.sched_priority(t) for t in range(rounds)]
    if st.scenario is not None:
        masks = [st.scenario(t) for t in range(rounds)]
        out["avail"] = [a for a, _ in masks]
        out["drop"] = [d for _, d in masks]
    if st.compress_mask is not None:
        out["compress_mask"] = [st.compress_mask(r)
                                for r in range(rounds + 1)]
    if st.quant_key is not None:
        shape = (ref.cohort_size, ref.compress_s)
        out["quant_uniform"] = [jax.random.uniform(st.quant_key(r), shape)
                                for r in range(rounds + 1)]
    out = {name: np.stack([np.asarray(a) for a in arrs])
           for name, arrs in out.items()}
    eng = ref.engine
    if eng._steps_k is not None or eng._batch_k is not None:
        def host(a):
            return None if a is None else np.asarray(a)
        out["traits"] = ScenarioTraits(None, None, host(eng._steps_k),
                                       host(eng._batch_k))
    return out


def port(data, transmit, draws=None, scenario=None, k=K, chan=None, **kw):
    x, y, parts = data
    clients = [tfl.FLClient(d, tloss, batch_size=32, lr=0.1, local_steps=5)
               for d in tbuild(x, y, parts)]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    _jax_params()),
                             device="cpu")
    sc = None if scenario is None else tcore.ScenarioConfig(**scenario)
    if draws is not None:
        draws = tfl.ArrayDraws(device="cpu", **draws)
    return tfl.FusedPAOTA(params, clients,
                          tcore.ChannelConfig(**(chan or {})),
                          tcore.SchedulerConfig(n_clients=k, seed=1),
                          tfl.PAOTAConfig(transmit=transmit), device="cpu",
                          draws=draws, scenario=sc, **kw)


def pair(data, transmit, rounds=R, scenario=None, **kw):
    ref = reference(data, transmit, scenario, **kw)
    return ref, port(data, transmit, reference_draws(ref, rounds),
                     scenario, **kw)


def step_pair(ref, prt, fields=STATE):
    """One round of both; the named carry planes must be bit-equal and the
    uploader counts and clocks equal. Returns the two history rows."""
    a, b = ref.advance(1)[0], prt.advance(1)[0]
    for f in fields:
        want = np.asarray(getattr(ref._carry, f))
        got = getattr(prt._carry, f).numpy()
        assert np.array_equal(got, want), (f, a["round"])
    assert b["n_participants"] == a["n_participants"]
    assert b["time"] == a["time"]
    return a, b


def assert_metrics_close(a, b, tol):
    """The reference's own fused-vs-host row contract
    (tests/test_fused_round.py:52-54): equal uploaders and clocks (checked
    by ``step_pair``), varsigma at ``tol``; the staleness mean is exact.
    beta_mean is the water-filling's output, fixed only to about
    sqrt(eps_f32) on a flat P2 objective, and that contract leaves it out
    (ROADMAP Queue 3 item 1)."""
    assert b["mean_staleness"] == a["mean_staleness"]
    assert b["varsigma"] == pytest.approx(a["varsigma"], rel=tol["varsigma"])


def assert_global_close(ref, prt, tol):
    np.testing.assert_allclose(prt.global_vec, ref.global_vec,
                               rtol=tol["rtol"], atol=tol["atol"])


def drift(tag, ref, prt):
    """Print how far the two globals are apart (read with pytest -s)."""
    gap = float(np.abs(ref.global_vec - prt.global_vec).max())
    print(f"\n{tag}: round {len(ref.history)}: max |w_g diff| {gap:.3e}")
    return gap


@pytest.mark.parametrize("with_scenario", [False, True],
                         ids=["no_scenario", "scenario"])
@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_cohort_round_tracks_reference(data, transmit, with_scenario):
    """Slot maps and the (K,) state plane bit-equal every round; w_g and
    the metrics within the reference's tolerance every round."""
    ref, prt = pair(data, transmit, cohort_size=M,
                    scenario=SCENARIO if with_scenario else None)
    tol = TOL[transmit]
    for _ in range(R):
        a, b = step_pair(ref, prt)
        assert_metrics_close(a, b, tol)
        assert_global_close(ref, prt, tol)
    drift(f"cohort transmit={transmit} scenario={with_scenario}", ref, prt)
    rows = prt.history
    assert all(r["n_participants"] <= M for r in rows)
    assert any(r["n_participants"] > 0 for r in rows)
    assert any(r["mean_staleness"] > 0 for r in rows)
    assert set(rows[0]) == set(ref.history[0])


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_full_cohort_matches_port_dense_round(data, transmit):
    """m = K: every client keeps a slot, so the cohort step is the dense
    round up to slot order (tests/test_cohort_round.py:63-80, the
    reference's own tolerances)."""
    dense = port(data, transmit)
    coh = port(data, transmit, cohort_size=K)
    for a, b in zip(dense.advance(6), coh.advance(6)):
        assert a["n_participants"] == b["n_participants"]
        assert a["time"] == b["time"]
        assert a["mean_staleness"] == pytest.approx(b["mean_staleness"],
                                                    abs=1e-6)
        assert a["varsigma"] == pytest.approx(b["varsigma"], rel=1e-3)
    np.testing.assert_allclose(dense.global_vec, coh.global_vec, rtol=1e-4,
                               atol=1e-5)


def _jax_scatter_max(k, rows, flags):
    return np.asarray(jnp.zeros((k,), bool).at[jnp.asarray(rows)].max(
        jnp.asarray(flags), mode="drop"))


def _jax_set_rows(plane, rows, vals, flags):
    tgt = np.where(flags, rows, plane.shape[0])
    return np.asarray(jnp.asarray(plane).at[jnp.asarray(tgt)].set(
        jnp.asarray(vals), mode="drop"))


@pytest.mark.parametrize("seed", range(6))
def test_duplicate_occupant_ids_reduce_like_the_reference(seed):
    """A dead slot keeps its last occupant's id, which a live slot may hold
    too: the turnover scatters reduce duplicates (``.at[].max``) and the
    residual park/consume writes (``.at[where(flag, id, K)].set``) land as
    the reference's do, whatever the slot order."""
    rng = np.random.default_rng(seed)
    k, m, s = 9, 6, 5
    live_ids = rng.choice(k, size=3, replace=False)
    rows = np.concatenate([live_ids, rng.choice(live_ids, size=m - 3)])
    perm = rng.permutation(m)
    rows = rows[perm].astype(np.int32)
    flags = np.concatenate([np.ones(3, bool), np.zeros(m - 3, bool)])[perm]
    flags &= rng.random(m) < 0.8
    got = trt._scatter_any(k, torch.from_numpy(rows),
                           torch.from_numpy(flags)).numpy()
    np.testing.assert_array_equal(got, _jax_scatter_max(k, rows, flags))
    plane = rng.standard_normal((k, s)).astype(np.float32)
    vals = rng.standard_normal((m, s)).astype(np.float32)
    got = trt._set_rows(torch.from_numpy(plane), torch.from_numpy(rows),
                        torch.from_numpy(vals), torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_set_rows(plane, rows, vals, flags))
    np.testing.assert_array_equal(
        trt._set_rows(torch.from_numpy(plane), torch.from_numpy(rows),
                      torch.zeros((m, s)), torch.from_numpy(flags)).numpy(),
        _jax_set_rows(plane, rows, np.zeros((m, s), np.float32), flags))


def test_live_slots_hold_distinct_clients(data):
    """Over the availability cycle the live slots always hold distinct
    clients, and the parked-residual writes touch only the clients of
    departing live slots."""
    prt = port(data, "delta", cohort_size=10, scenario=SCENARIO,
               compress="topk", compress_ratio=0.1)
    for _ in range(12):
        before = prt._ensure_carry()
        prt.advance(1)
        occ = prt._carry.slot_client.numpy()
        live = prt._carry.slot_live.numpy()
        ids = occ[live]
        assert len(set(ids.tolist())) == len(ids)
        changed = np.flatnonzero(
            (prt._carry.resid_idx != before.resid_idx).any(1).numpy())
        assert set(changed) <= set(before.slot_client.numpy()[
            before.slot_live.numpy()].tolist())
    assert np.isfinite(prt.global_vec).all()


def test_cohort_carry_is_m_sized(data):
    prt = port(data, "delta", cohort_size=3)
    prt.advance(2)
    assert prt._carry.pending is None
    assert tuple(prt._carry.deltas.shape) == (3, prt.d)
    assert tuple(prt._carry.ready.shape) == (K,)
    assert prt._carry.slot_idx is None


def test_cohort_validation_mirrors_the_reference(data):
    """FusedPAOTA refuses what the reference refuses, with its messages."""
    cases = [
        (dict(cohort_size=K + 1), ValueError, "cohort_size"),
        (dict(cohort_size=-2), ValueError, "cohort_size"),
        (dict(compress="topk"), ValueError, "cohort_size=m"),
        (dict(cohort_size=4, compress="lowrank"), ValueError, "compress="),
        (dict(cohort_size=4, slot_dtype="int8"), ValueError, "slot_dtype"),
        (dict(cohort_size=4, compress="topk", slot_dtype="fp8"),
         ValueError, "slot_dtype="),
        (dict(cohort_size=4, compress="topk", compress_ratio=1.5),
         ValueError, "compress_ratio"),
    ]
    for kw, exc, match in cases:
        with pytest.raises(exc, match=match):
            port(data, "delta", **kw)
        with pytest.raises(exc, match=match):
            reference(data, "delta", **kw)
    with pytest.raises(ValueError, match="transmit='delta'"):
        port(data, "model", cohort_size=4, compress="topk")


def test_cohort_counter_draws_chunking_keeps_the_trajectory(data):
    """CounterDraws keys every cohort draw (priorities, masks, supports,
    dither, traits) on (seed, round, tag): advance(7) then advance(5)
    lands on the advance(12) trajectory bit for bit."""
    kw = dict(cohort_size=M, scenario=SCENARIO, compress="randmask",
              compress_ratio=0.1, slot_dtype="int8", error_feedback=False)
    one = port(data, "delta", **kw)
    rows = one.advance(12)
    two = port(data, "delta", **kw)
    two.advance(7)
    two.advance(5)
    np.testing.assert_array_equal(one.global_vec, two.global_vec)
    assert rows == two.history
    assert any(r["n_participants"] > 0 for r in rows)


def test_cli_runs_cohort_compressed_on_cpu(capsys, tmp_path):
    """The paper driver's --cohort-size / --compress / --compress-ratio /
    --slot-dtype flags on the fused engine, at K = 6 for 3 rounds."""
    from repro_torch.launch import fl_train
    fl_train.main(["--rounds", "3", "--clients", "6", "--device", "cpu",
                   "--transmit", "delta", "--engine", "fused",
                   "--cohort-size", "3", "--compress", "topk",
                   "--compress-ratio", "0.1", "--slot-dtype", "int8",
                   "--out", str(tmp_path / "fl.csv")])
    out = capsys.readouterr().out
    assert "cohort=3, compress=topk" in out
    assert "=== paota === final acc" in out
