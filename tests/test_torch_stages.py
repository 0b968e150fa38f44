"""Port stages of one PAOTA period held against their JAX counterparts on
the same inputs: scheduler transition and the host scheduler, eq.-25
factors, water-filling P2 and the host P2 solvers, channel and power cap
(7), the guarded update."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import aircomp as jair  # noqa: E402
from repro.core import boxqp as jbox  # noqa: E402
from repro.core import dinkelbach as jdink  # noqa: E402
from repro.core import power_control as jpc  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import aircomp as tair  # noqa: E402
from repro_torch.core import boxqp as tbox  # noqa: E402
from repro_torch.core import dinkelbach as tdink  # noqa: E402
from repro_torch.core import power_control as tpc  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402

T = torch.from_numpy


def _np(a):
    return np.array(a)


@pytest.mark.parametrize("delta_t", [8.0, 0.1])
def test_scheduler_transition_bit_equal(delta_t):
    """sched_advance / sched_broadcast over 60 rounds of random latency
    draws: ready masks, staleness, latencies and model rounds bit-equal
    (delta_t=0.1 is the slot-clock stress case of tests/test_slot_clock.py)."""
    rng = np.random.default_rng(3)
    k = 64
    ready_j = jnp.zeros(k, bool)
    lat_j = jnp.asarray(rng.uniform(0.5, 1.5, k) * delta_t, jnp.float32)
    mr_j = jnp.zeros(k, jnp.int32)
    ready_t, lat_t, mr_t = T(_np(ready_j)), T(_np(lat_j)), T(_np(mr_j))
    for r in range(60):
        ready_j, stal_j = jsched.sched_advance(ready_j, lat_j, mr_j, r,
                                               delta_t)
        ready_t, stal_t = tsched.sched_advance(ready_t, lat_t, mr_t, r,
                                               delta_t)
        np.testing.assert_array_equal(ready_t.numpy(), _np(ready_j))
        np.testing.assert_array_equal(stal_t.numpy(), _np(stal_j))
        upl = _np(ready_j) & (rng.random(k) < 0.8)
        new_lat = rng.uniform(0.5, 3.0, k).astype(np.float32) * np.float32(
            delta_t)
        ready_j, lat_j, mr_j = jsched.sched_broadcast(
            ready_j, lat_j, mr_j, jnp.asarray(upl), jnp.asarray(new_lat),
            r + 1)
        ready_t, lat_t, mr_t = tsched.sched_broadcast(
            ready_t, lat_t, mr_t, T(upl), T(new_lat), r + 1)
        for got, want in ((ready_t, ready_j), (lat_t, lat_j), (mr_t, mr_j)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
            assert got.dtype == getattr(torch, str(_np(want).dtype))


def _p2_inputs(rng, k, p_active=0.6):
    rho = (3.0 / (rng.integers(0, 4, k) + 3.0)).astype(np.float32)
    theta = rng.uniform(0.2, 0.9, k).astype(np.float32)
    b = (rng.random(k) < p_active).astype(np.float32)
    return rho, theta, np.full(k, 15.0, np.float32), b


def _both_waterfills(rho, theta, pm, b, c1, c0):
    bj, oj = jax.jit(jbox.waterfill_beta_jnp,
                     static_argnames=("c1", "c0"))(rho, theta, pm, b,
                                                   c1=c1, c0=c0)
    bt, ot = tbox.waterfill_beta(T(rho), T(theta), T(pm), T(b), c1, c0)
    return _np(bj), float(oj), bt.numpy(), float(ot)


@pytest.mark.parametrize("k,seed", [(8, 0), (8, 1), (24, 2), (100, 3)])
def test_waterfill_matches_reference(k, seed):
    """Objective rel 1e-5, the reference's own tolerance for this solver
    under another reduction order (tests/test_sharded_round.py:167). Near
    its optimum the P2 ratio is flat in tau, so f32 rounding (XLA contracts
    a*b+c into FMAs, torch does not) fixes tau only to ~sqrt(eps_f32); the
    transmit powers t_k = p_k(beta_k) inherit that (rtol 1e-3), and beta
    divides it by p_max (rho_k - theta_k), so beta is compared through the
    powers it sets."""
    rng = np.random.default_rng(seed)
    c1, c0 = jpc.p2_constants(10.0, 0.05, k, 8070,
                              jair.ChannelConfig().sigma_n2)
    for _ in range(10):
        rho, theta, pm, b = _p2_inputs(rng, k)
        if not b.any():
            b[0] = 1.0
        bj, oj, bt, ot = _both_waterfills(rho, theta, pm, b, c1, c0)
        assert ot == pytest.approx(oj, rel=1e-5)
        assert bt.min() >= 0.0 and bt.max() <= 1.0
        pj = _np(jpc.power_from_beta(jnp.asarray(bj), rho, theta, pm)) * b
        pt = _np(jpc.power_from_beta(jnp.asarray(bt), rho, theta, pm)) * b
        np.testing.assert_allclose(pt, pj, rtol=1e-3)


def test_waterfill_bit_equal_to_reference_jit():
    """The port rounds each multiply-add that XLA:CPU compiles into an FMA
    once, and sums over K in the reference's order (K <= 24): on 40 random
    P2 instances at K = 8, beta and the objective come out bit-equal to
    jax.jit(waterfill_beta_jnp) (14 of 40 were before; ROADMAP Queue 3).
    Every interior t_k equals tau, so beta bit-equal means tau bit-equal."""
    rng = np.random.default_rng(8)
    k = 8
    c1, c0 = jpc.p2_constants(10.0, 0.05, k, 8070,
                              jair.ChannelConfig().sigma_n2)
    same_beta = same_obj = 0
    for _ in range(40):
        rho, theta, pm, b = _p2_inputs(rng, k)
        b[0] = 1.0
        bj, oj, bt, ot = _both_waterfills(rho, theta, pm, b, c1, c0)
        same_beta += int(np.array_equal(bt, bj))
        same_obj += int(ot == oj)
    print(f"\nwater-filling bit-equal at K={k}: beta {same_beta}/40, "
          f"objective {same_obj}/40")
    assert (same_beta, same_obj) == (40, 40)


def test_waterfill_sharded_test_case():
    """The reference's sharded-vs-single-device case, verbatim inputs and
    tolerances (beta atol 2e-3, objective rel 1e-5)."""
    k = 24
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.2, 1.0, k).astype(np.float32)
    theta = rng.uniform(0.0, 1.0, k).astype(np.float32)
    b = (rng.random(k) < 0.7).astype(np.float32)
    bj, oj, bt, ot = _both_waterfills(rho, theta, np.full(k, 15.0,
                                                          np.float32),
                                      b, 8.0, 1e-4)
    assert ot == pytest.approx(oj, rel=1e-5)
    np.testing.assert_allclose(bt, bj, atol=2e-3)


def test_waterfill_no_uploader_matches_bit_for_bit():
    """b = 0: every grid value is c0 / 1e-30, the first cell wins, and the
    degenerate beta/objective equal the reference's exactly."""
    rng = np.random.default_rng(5)
    rho, theta, pm, _ = _p2_inputs(rng, 8)
    b = np.zeros(8, np.float32)
    bj, oj, bt, ot = _both_waterfills(rho, theta, pm, b, 0.2, 1.28e-8)
    np.testing.assert_array_equal(bt, bj)
    assert ot == oj


def test_waterfill_tied_grid_takes_lowest_index():
    """rho == theta for every client: t no longer depends on tau, all 4096
    grid values tie, and both solvers take the lowest cell; beta is the
    0.5 of the degenerate branch, bit for bit."""
    k = 8
    rho = np.full(k, 0.75, np.float32)
    b = np.ones(k, np.float32)
    bj, oj, bt, ot = _both_waterfills(rho, rho.copy(),
                                      np.full(k, 15.0, np.float32), b,
                                      0.2, 1.28e-8)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(bt, np.full(k, 0.5, np.float32))
    assert ot == pytest.approx(oj, rel=1e-6)


def test_waterfill_grid_is_reference_linspace():
    lin = np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, 4096))())
    np.testing.assert_array_equal(tbox._grid(4096, "cpu").numpy(), lin)


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_round_factors_match_reference(transmit):
    rng = np.random.default_rng(7)
    k, d = 12, 8070
    deltas = (0.01 * rng.normal(size=(k, d))).astype(np.float32)
    pending = (rng.normal(size=(k, d))).astype(np.float32)
    g = rng.normal(size=d).astype(np.float32)
    prev = (g + 0.01 * rng.normal(size=d)).astype(np.float32)
    stal = rng.integers(0, 4, k).astype(np.float32)
    payload = None if transmit == "delta" else pending
    rj, thj, wj = jrt.round_factors(jnp.asarray(deltas),
                                    None if payload is None
                                    else jnp.asarray(payload),
                                    jnp.asarray(g), jnp.asarray(prev),
                                    jnp.asarray(stal), 3.0)
    rt, tht, wt = trt.round_factors(T(deltas), None if payload is None
                                    else T(payload), T(g), T(prev),
                                    T(stal), 3.0)
    np.testing.assert_array_equal(rt.numpy(), _np(rj))
    np.testing.assert_allclose(tht.numpy(), _np(thj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), _np(wj), rtol=3e-5)


def test_round_factors_zero_direction_gives_half():
    """w_g == prev (round 0): the direction is 0, cos -> 0, theta = 1/2."""
    d = torch.ones((3, 10))
    g = torch.ones(10)
    _, theta, _ = trt.round_factors(d, None, g, g.clone(), torch.zeros(3),
                                    3.0)
    np.testing.assert_array_equal(theta.numpy(), np.full(3, 0.5, np.float32))


def test_power_stages_match_reference():
    rng = np.random.default_rng(9)
    k = 32
    beta = rng.uniform(0, 1, k).astype(np.float32)
    rho, theta, pm, _ = _p2_inputs(rng, k)
    s = rng.integers(0, 6, k).astype(np.float32)
    np.testing.assert_array_equal(
        tpc.staleness_factor(T(s), 3.0).numpy(),
        _np(jpc.staleness_factor(jnp.asarray(s), 3.0)))
    cos = rng.uniform(-1, 1, k).astype(np.float32)
    np.testing.assert_array_equal(
        tpc.similarity_factor(T(cos)).numpy(),
        _np(jpc.similarity_factor(jnp.asarray(cos))))
    p_t = tpc.power_from_beta(T(beta), T(rho), T(theta), T(pm))
    p_j = jpc.power_from_beta(jnp.asarray(beta), jnp.asarray(rho),
                              jnp.asarray(theta), jnp.asarray(pm))
    np.testing.assert_allclose(p_t.numpy(), _np(p_j), rtol=1e-6)
    w2 = rng.uniform(1e-3, 100, k).astype(np.float32)
    h = rng.rayleigh(1.0, k).astype(np.float32)
    np.testing.assert_allclose(
        trt.constraint7_powers(p_t, T(h), 15.0, T(w2)).numpy(),
        _np(jrt.constraint7_powers(p_j, None, jnp.asarray(h), 15.0,
                                   w_norm2=jnp.asarray(w2))), rtol=1e-6)
    assert tpc.p2_constants(10.0, 0.05, 100, 8070, 1e-13) == \
        jpc.p2_constants(10.0, 0.05, 100, 8070, 1e-13)


def test_channel_matches_reference():
    chan_j, chan_t = jair.ChannelConfig(), tair.ChannelConfig()
    assert chan_t.sigma_n == chan_j.sigma_n
    assert chan_t.sigma_n2 == chan_j.sigma_n2
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, (50,), minval=1e-6, maxval=1.0)
    np.testing.assert_allclose(
        tair.rayleigh_from_uniform(T(_np(u)), chan_t).numpy(),
        _np(jair.sample_channel_gains(key, 50, chan_j)), rtol=1e-6)
    h = tair.sample_channel_gains(0, 3, 1000, chan_t, "cpu")
    assert h.shape == (1000,) and h.dtype == torch.float32
    assert bool((h > 0).all())
    # Rayleigh(1): mean sqrt(pi/2)
    assert float(h.mean()) == pytest.approx(np.sqrt(np.pi / 2), rel=0.1)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_aircomp_aggregate_matches_reference(use_kernel):
    """aircomp_aggregate on both routes, with the reference's own AWGN
    realization handed in, and the eq.-8 weights and noise variance."""
    rng = np.random.default_rng(2)
    k, d = 12, 8070
    x = rng.normal(size=(k, d)).astype(np.float32)
    p = rng.uniform(0.1, 15.0, k).astype(np.float32)
    m = (rng.random(k) < 0.6).astype(np.float32)
    chan = jair.ChannelConfig()
    key = jax.random.PRNGKey(9)
    aj, vj = jair.aircomp_aggregate(jnp.asarray(x), jnp.asarray(p),
                                    jnp.asarray(m), key, chan.sigma_n,
                                    use_kernel=use_kernel)
    noise = chan.sigma_n * jax.random.normal(key, (d,), jnp.float32)
    at, vt = tair.aircomp_aggregate(T(x), T(p), T(m), T(_np(noise)),
                                    use_kernel=use_kernel)
    np.testing.assert_allclose(at.numpy(), _np(aj), rtol=3e-5, atol=3e-5)
    assert float(vt) == pytest.approx(float(vj), rel=1e-6)
    np.testing.assert_allclose(
        tair.aggregation_weights(T(p), T(m)).numpy(),
        _np(jair.aggregation_weights(jnp.asarray(p), jnp.asarray(m))),
        rtol=1e-6)
    assert float(tair.equivalent_noise_var(
        chan.sigma_n2, T(p), T(m), d)) == pytest.approx(float(
            jair.equivalent_noise_var(chan.sigma_n2, jnp.asarray(p),
                                      jnp.asarray(m), d)), rel=1e-5)


@pytest.mark.parametrize("delta", [False, True])
def test_guarded_update_matches_and_holds(delta):
    rng = np.random.default_rng(1)
    d = 257
    g = rng.normal(size=d).astype(np.float32)
    prev = rng.normal(size=d).astype(np.float32)
    agg = rng.normal(size=d).astype(np.float32)
    for vs in (3.5, 1e-12, 0.0):
        nj, pj = jagg.guarded_global_update(
            jnp.asarray(g), jnp.asarray(prev), jnp.asarray(agg),
            jnp.float32(max(vs, 1e-12)), delta=delta)
        nt, pt = tagg.guarded_global_update(
            T(g), T(prev), T(agg), torch.tensor(max(vs, 1e-12)),
            delta=delta)
        np.testing.assert_array_equal(nt.numpy(), _np(nj))
        np.testing.assert_array_equal(pt.numpy(), _np(pj))
        if vs <= 1e-12:                         # zero uploaders: hold
            np.testing.assert_array_equal(nt.numpy(), g)
            np.testing.assert_array_equal(pt.numpy(), prev)
    bad = agg.copy()
    bad[7] = np.nan
    nt, pt = tagg.guarded_global_update(T(g), T(prev), T(bad),
                                        torch.tensor(3.5), delta=delta)
    np.testing.assert_array_equal(nt.numpy(), g)    # non-finite: hold
    np.testing.assert_array_equal(pt.numpy(), prev)


def test_counter_draws_are_keyed_not_sequential():
    """The same (seed, round, tag) gives the same draw in any call order;
    rounds and tags give different streams."""
    a = tsched.counter_latencies(1, 5, 16, 5.0, 15.0, "cpu")
    tsched.counter_latencies(1, 4, 16, 5.0, 15.0, "cpu")
    b = tsched.counter_latencies(1, 5, 16, 5.0, 15.0, "cpu")
    c = tsched.counter_latencies(1, 6, 16, 5.0, 15.0, "cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a.dtype == torch.float32
    assert float(a.min()) >= 5.0 and float(a.max()) <= 15.0
    assert (tsched.round_tag_seed(1, 5, tsched.TAG_LATENCY)
            != tsched.round_tag_seed(1, 5, tsched.TAG_CHANNEL))


def _p2_pair(rng, k, p_active=0.7):
    rho, theta, pm, b = _p2_inputs(rng, k, p_active)
    b[0] = 1.0
    kw = dict(smooth_l=10.0, eps_bound=0.05, model_dim=8070,
              sigma_n2=jair.ChannelConfig().sigma_n2)
    args = (rho.astype(float), theta.astype(float), pm.astype(float),
            b.astype(float))
    return jpc.build_p2(*args, **kw), tpc.build_p2(*args, **kw)


@pytest.mark.parametrize("solver,k", [("waterfill", 12), ("prefix", 12),
                                      ("pgd", 8), ("milp", 4),
                                      ("exhaustive", 4)])
def test_host_p2_solvers_match_reference(solver, k):
    """The numpy solvers are copies: beta and the objective to rtol 1e-9 on
    the same P2Problem (the prefix evaluator forced at small K)."""
    rng = np.random.default_rng(k)
    for _ in range(3):
        pj, pt = _p2_pair(rng, k)
        if solver == "prefix":
            rj = jbox.solve_waterfill(pj, method="prefix")
            rt = tbox.solve_waterfill(pt, method="prefix")
        else:
            rj, rt = jdink.solve_p2(pj, solver), tdink.solve_p2(pt, solver)
        np.testing.assert_allclose(rt.beta, rj.beta, rtol=1e-9, atol=1e-12)
        assert rt.objective == pytest.approx(rj.objective, rel=1e-9)
        assert (rt.iterations, rt.inner) == (rj.iterations, rj.inner)
    (gj, qj), (gt, qt) = pj.quadratics(), pt.quadratics()
    for a, b_ in zip(gj + qj, gt + qt):
        np.testing.assert_allclose(b_, a, rtol=1e-12)


def test_waterfill_jnp_solver_name_runs_the_f32_solver():
    rng = np.random.default_rng(6)
    pj, pt = _p2_pair(rng, 8)
    rj = jdink.solve_p2(pj, "waterfill_jnp")
    rt = tdink.solve_p2(pt, "waterfill_jnp", device="cpu")
    np.testing.assert_array_equal(rt.beta, rj.beta)
    assert rt.objective == rj.objective and rt.inner == "waterfill_jnp"
    with pytest.raises(ValueError, match="solver"):
        tdink.solve_p2(pt, "cplex")


@pytest.mark.parametrize("rng_mode", ["host", "counter"])
def test_host_scheduler_bit_equal_over_50_rounds(rng_mode):
    """SemiAsyncScheduler in both rng modes: uploaders, staleness, latency
    draws (f64 PCG64 / f32 counter), model rounds and the straggler clock
    bit-equal to the reference's, with partial re-broadcasts. Counter mode
    hands the reference's keyed latencies to the port."""
    k = 24
    cfg = dict(n_clients=k, delta_t=8.0, seed=5, rng=rng_mode)
    ref = jsched.SemiAsyncScheduler(jsched.SchedulerConfig(**cfg))
    lat_key = jax.random.PRNGKey(5)
    port = tsched.SemiAsyncScheduler(
        tsched.SchedulerConfig(**cfg),
        latencies=lambda r: _np(jsched.counter_latencies(lat_key, r, k, 5.0,
                                                         15.0)))
    pick = np.random.default_rng(0)
    ids = np.arange(k)
    for _ in range(50):
        ref.start_round(ids)
        port.start_round(ids)
        uj, sj = ref.advance_to_aggregation()
        ut, st = port.advance_to_aggregation()
        np.testing.assert_array_equal(ut, uj)
        np.testing.assert_array_equal(st, sj)
        for name in ("busy_lat", "model_round", "ready"):
            got, want = getattr(port, name), getattr(ref, name)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert (port.round, port.time) == (ref.round, ref.time)
        ids = uj[pick.random(len(uj)) < 0.7]
    assert port.sync_round_time(7) == ref.sync_round_time(7)
