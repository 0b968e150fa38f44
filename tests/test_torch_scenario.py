"""The port's scenario simulator against the reference: ScenarioConfig and
its validation, the availability / dropout masks and the static traits
bit for bit from the reference's own draws, the lognormal latencies at
rtol 1e-6, the host scheduler under a scenario over 10 rounds, the dense
fused round's scenario branch, and the engine's per-client heterogeneity
(masked local steps, the cyclic het-batch plan)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import scheduler as jsch  # noqa: E402
from repro.core.scheduler import (TAG_AVAIL, TAG_DROPOUT,  # noqa: E402
                                  TAG_LATENCY, TAG_TRAIT, round_tag_key)
from repro.data import partition as jpart  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.fl.client import FLClient as JClient  # noqa: E402
from repro.fl.engine import BatchedEngine as JEngine  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.fl.client import FLClient as TClient  # noqa: E402
from repro_torch.fl.engine import BatchedEngine as TEngine  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

from test_torch_cohort import SCENARIO, TOL, assert_global_close  # noqa: E402,E501
from test_torch_cohort import assert_metrics_close, data, pair  # noqa: E402,F401,E501
from test_torch_cohort import step_pair  # noqa: E402

KS = 50
KEY = jax.random.PRNGKey(3)
SCENARIOS = {
    "always": dict(),
    "cycle": dict(availability="cycle", avail_period=4, avail_duty=0.5),
    "cycle_odd_duty": dict(availability="cycle", avail_period=7,
                           avail_duty=0.3, dropout_prob=0.2),
    "bernoulli": dict(availability="bernoulli", avail_prob=0.6),
    "bernoulli_dropout": dict(availability="bernoulli", avail_prob=0.8,
                              dropout_prob=0.3),
    "dropout": dict(dropout_prob=0.25),
}


def _both(**kw):
    return jsch.ScenarioConfig(**kw), tsch.ScenarioConfig(**kw)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kw", [
    dict(availability="sometimes"), dict(responsiveness="pareto"),
    dict(availability="cycle", avail_period=0), dict(dropout_prob=1.0),
    dict(dropout_prob=-0.1)])
def test_scenario_validation_mirrors_the_reference(kw):
    with pytest.raises(ValueError) as want:
        jsch.ScenarioConfig(**kw)
    with pytest.raises(ValueError) as got:
        tsch.ScenarioConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_has_masks_matches_the_reference(name):
    j, t = _both(**SCENARIOS[name])
    assert t.has_masks == j.has_masks
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_masks_bit_equal_from_replayed_draws(name):
    """(available, dropped) from the reference's own phase trait and
    per-round uniforms, rounds 0..7."""
    j, t = _both(**SCENARIOS[name])
    phase = np.asarray(jsch.scenario_traits(KEY, KS, j)[0])
    for r in range(8):
        ja, jd = jsch.scenario_masks(KEY, r, KS, j)
        ua = np.asarray(jax.random.uniform(round_tag_key(KEY, r, TAG_AVAIL),
                                           (KS,)))
        ud = np.asarray(jax.random.uniform(
            round_tag_key(KEY, r, TAG_DROPOUT), (KS,)))
        ta, td = tsch.scenario_masks(t, r, KS, T(phase), T(ua), T(ud))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_scenario_traits_bit_equal_from_replayed_draws():
    kw = dict(availability="cycle", avail_period=6, responsiveness=
              "lognormal", lat_mu_spread=0.7, het_steps=(1, 3, 5),
              het_batch=(8, 16, 32))
    j, t = _both(**kw)
    tk = round_tag_key(KEY, 0, TAG_TRAIT)
    phase, mu = jsch.scenario_traits(KEY, KS, j)
    steps_k, batch_k = jsch.scenario_hyperparams(KEY, KS, j)
    z = jax.random.normal(jax.random.fold_in(tk, 1), (KS,), jnp.float32)
    picks = [jax.random.randint(jax.random.fold_in(tk, f), (KS,), 0, n)
             for f, n in ((2, 3), (3, 3))]
    got = tsch.scenario_traits(t, T(phase), T(z), T(picks[0]), T(picks[1]))
    for g, w in zip(got, (phase, mu, steps_k, batch_k)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    none = tsch.scenario_traits(tsch.ScenarioConfig(), T(phase), T(z),
                                T(picks[0]), T(picks[1]))
    assert none == (None, None, None, None)


@pytest.mark.parametrize("shift", [0.0, 2.5])
def test_lognormal_latencies_match_reference(shift):
    """ndtri through torch.special, the clip of u and the f32 log(med)
    kept: rtol 1e-6 against the reference's scenario_latencies."""
    j, t = _both(responsiveness="lognormal", lat_shift=shift,
                 lat_sigma=0.4)
    _, mu = jsch.scenario_traits(KEY, KS, j)
    for r in range(5):
        u = jax.random.uniform(round_tag_key(KEY, r, TAG_LATENCY), (KS,))
        want = np.asarray(jsch.scenario_latencies(KEY, r, KS, 5.0, 15.0, j))
        got = tsch.lognormal_latencies(t, T(u), T(mu), 5.0, 15.0)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # u at the clip edges stays finite
    edge = tsch.lognormal_latencies(t, torch.tensor([0.0, 1.0 - 1e-9]),
                                    torch.zeros(2), 5.0, 15.0)
    assert bool(torch.isfinite(edge).all())


def test_uniform_responsiveness_is_the_plain_counter_stream():
    sc = tsch.ScenarioConfig(availability="cycle")
    for r in range(3):
        np.testing.assert_array_equal(
            tsch.counter_scenario_latencies(7, r, KS, 5.0, 15.0, sc, None,
                                            "cpu").numpy(),
            tsch.counter_latencies(7, r, KS, 5.0, 15.0, "cpu").numpy())


@pytest.mark.parametrize("name", ["cycle", "bernoulli_dropout"])
def test_host_scheduler_under_scenario_tracks_reference(name):
    """The host SemiAsyncScheduler(scenario=) over 10 rounds on the
    reference's latencies and masks: uploaders, staleness, the restart
    set and the (K,) state equal every round."""
    kw = dict(SCENARIOS[name], responsiveness="lognormal")
    j, t = _both(**kw)
    cfg = dict(n_clients=KS, seed=5, rng="counter")
    ref = jsch.SemiAsyncScheduler(jsch.SchedulerConfig(**cfg), scenario=j)
    key = jax.random.PRNGKey(5)

    def lat(r):
        return np.asarray(jsch.scenario_latencies(key, r, KS, 5.0, 15.0, j))

    def masks(r):
        return tuple(np.asarray(m) for m in jsch.scenario_masks(key, r, KS,
                                                                j))
    prt = tsch.SemiAsyncScheduler(tsch.SchedulerConfig(**cfg), scenario=t,
                                  latencies=lat, masks=masks)
    held = 0
    for _ in range(10):
        ref.start_round(ref.restart_ids)
        prt.start_round(prt.restart_ids)
        (ju, js), (tu, ts) = (ref.advance_to_aggregation(),
                              prt.advance_to_aggregation())
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(prt.restart_ids, ref.restart_ids)
        for f in ("ready", "busy_lat", "model_round"):
            np.testing.assert_array_equal(getattr(prt, f), getattr(ref, f))
        held += int((ref.ready & ~np.isin(np.arange(KS),
                                          ref.restart_ids)).sum())
    assert held > 0                  # someone held an update while away


def test_host_scheduler_scenario_needs_counter_rng():
    with pytest.raises(ValueError, match="counter"):
        tcore.SemiAsyncScheduler(tcore.SchedulerConfig(),
                                 scenario=tcore.ScenarioConfig())
    sched = tcore.SemiAsyncScheduler(
        tcore.SchedulerConfig(n_clients=KS, rng="counter"),
        scenario=tcore.ScenarioConfig(**SCENARIOS["bernoulli_dropout"]))
    for _ in range(4):
        sched.start_round(sched.restart_ids)
        upl, _ = sched.advance_to_aggregation()
        assert set(upl) <= set(sched.restart_ids)


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_dense_round_scenario_branch_tracks_reference(data, transmit):
    """The dense fused round with the cycle + dropout + lognormal +
    het_steps scenario: unavailable-but-ready clients hold their update,
    dropped uploads restart; the ready bits and model rounds bit-equal
    every round and w_g within the fused round's tolerance. (busy_lat is
    a replayed draw: the reference evaluates its lognormal warp eagerly
    here and fused inside its scan, an ulp apart.)"""
    ref, prt = pair(data, transmit, rounds=12, scenario=SCENARIO)
    tol = TOL[transmit]
    for _ in range(12):
        a, b = step_pair(ref, prt, ("ready", "model_round"))
        assert_metrics_close(a, b, tol)
        assert_global_close(ref, prt, tol)
    assert any(r["n_participants"] > 0 for r in prt.history)


def _engines(data, k=6, steps=5):
    x, y = data[0], data[1]
    parts = jpart.partition_noniid(y, n_clients=k, seed=0)
    je = JEngine.from_clients([JClient(d, jmlp.mlp_loss, 32, 0.1, steps)
                               for d in jpipe.build_federation(x, y,
                                                               parts)])
    te = TEngine.from_clients([TClient(d, tmlp.mlp_loss, 32, 0.1, steps)
                               for d in tpipe.build_federation(x, y,
                                                               parts)],
                              device="cpu")
    je.enable_counter_plan(jax.random.PRNGKey(0))
    return je, te


def _np_params(seed):
    return jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp_params(jax.random.PRNGKey(seed)))


def test_masked_local_steps_match_reference_engine(data):
    """Heterogeneous step counts (exact zero steps past a client's count)
    against the reference's masked scan: rtol 1e-5, atol 1e-6, as the
    homogeneous local SGD."""
    je, te = _engines(data)
    steps = np.array([1, 5, 3, 2, 5, 4], np.int32)
    je.set_heterogeneity(steps_k=steps)
    te.set_heterogeneity(steps_k=steps)
    npp = _np_params(2)
    plan = np.array(je.round_plan(3))
    want = np.asarray(je._train_all(npp, je._x, je._y, jnp.asarray(plan),
                                    je.steps_for()))
    got = te.train_all(tmlp.params_from_jax(npp, device="cpu"), T(plan).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    ids = torch.tensor([4, 0, 2], dtype=torch.int32)
    rows = te.train_rows(tmlp.params_from_jax(npp, device="cpu"),
                         T(plan).long()[ids.long()], ids)
    np.testing.assert_array_equal(rows.numpy(), got.numpy()[[4, 0, 2]])


def test_masked_steps_equal_the_shorter_homogeneous_run(data):
    """A client with n_steps = s ends where s homogeneous steps on the
    same plan rows end, bit for bit: p - 0 * g == p."""
    _, te = _engines(data)
    te.set_heterogeneity(steps_k=[2, 2, 2, 2, 2, 2])
    _, te2 = _engines(data, steps=2)
    plan = tpipe.counter_batch_plan(1, 0, torch.as_tensor(te.n_samples),
                                    5, 32)
    params = tmlp.params_from_jax(_np_params(1), device="cpu")
    np.testing.assert_array_equal(
        te.train_all(params, plan).numpy(),
        te2.train_all(params, plan[:, :2]).numpy())


def test_heterogeneity_validation(data):
    _, te = _engines(data)
    with pytest.raises(ValueError, match="steps_k"):
        te.set_heterogeneity(steps_k=[0, 1, 1, 1, 1, 1])
    with pytest.raises(ValueError, match="steps_k"):
        te.set_heterogeneity(steps_k=[1, 2])
    with pytest.raises(ValueError, match="batch_k"):
        te.set_heterogeneity(batch_k=[33] * 6)
    te.set_heterogeneity(steps_k=[1] * 6, batch_k=[16] * 6)
    assert te.steps_for(torch.tensor([3, 1])).tolist() == [1, 1]


def test_het_batch_plan_folds_like_the_reference():
    """Column j of client k repeats draw j mod b_k; b_k = B is the
    homogeneous plan bit for bit (the reference's counter_batch_plan
    fold on the port's own draws)."""
    n = torch.tensor([300, 40, 1500])
    bk = torch.tensor([8, 32, 5], dtype=torch.int32)
    base = tpipe.counter_batch_plan(4, 2, n, 5, 32)
    got = tpipe.counter_batch_plan(4, 2, n, 5, 32, batch_sizes=bk)
    want = np.asarray(jax.vmap(lambda p, b: p[:, jnp.mod(jnp.arange(32),
                                                          b)])(
        jnp.asarray(base.numpy()), jnp.asarray(bk.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), base[1].numpy())
