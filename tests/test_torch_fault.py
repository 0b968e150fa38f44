"""Fault injection, screening, divergence rollback and checkpoint/resume in
the port's fused round, held against the reference's FusedPAOTA on the
reference's own draws (the fault uniforms included, through ArrayDraws):
K = 8 clients that all upload every period (tests/test_fault_round.py's
FAST_SCHED), make_mnist_like(n_train=2000), the MLP.

Each of the reference's single-device fault tests has its counterpart
here, with the same assertions on the port, and the port's globals held
against the reference's at the fused tolerance wherever the run is
finite. Resume is bit-exact inside the port, and a checkpoint passes
between the packages in both directions."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ChannelConfig, SchedulerConfig  # noqa: E402
from repro.core import scheduler as rsch  # noqa: E402
from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.pipeline import build_federation  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro.fl import FLClient, FusedPAOTA, PAOTAConfig  # noqa: E402
from repro.models.mlp import init_mlp_params, mlp_loss  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.scheduler as tsch  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
from repro_torch.data.pipeline import build_federation as tbuild  # noqa: E402
from repro_torch.models.mlp import mlp_loss as tloss  # noqa: E402
from repro_torch.models.mlp import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

K = 8
FAST_SCHED = dict(n_clients=K, delta_t=8.0, lat_lo=0.5, lat_hi=3.0, seed=1)
# the fused tolerance (ROADMAP Queue 3; tests/test_torch_fused.py TOL)
TOL = {"model": dict(rtol=1e-4, atol=1e-5),
       "delta": dict(rtol=1e-4, atol=5e-5)}


@pytest.fixture(scope="module")
def data():
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    return x, y, partition_noniid(y, n_clients=K, seed=0)


def _ref_faults(fc):
    return None if fc is None else rsch.FaultConfig(**vars(fc))


def reference(data, transmit="delta", faults=None, **kw):
    x, y, parts = data
    clients = [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=2)
               for d in build_federation(x, y, parts)]
    return FusedPAOTA(init_mlp_params(jax.random.PRNGKey(0)), clients,
                      ChannelConfig(), SchedulerConfig(**FAST_SCHED),
                      PAOTAConfig(transmit=transmit),
                      faults=_ref_faults(faults), **kw)


def reference_draws(ref, rounds):
    """Every draw the reference's round consumes for ``rounds`` rounds, as
    ArrayDraws arguments, the payload-fault and deep-fade uniforms keyed
    as the reference keys them (scheduler seed, TAG_FAULT, fold 1)."""
    from test_torch_cohort import reference_draws as cohort_draws
    from repro.core.aircomp import sample_channel_gains
    out = cohort_draws(ref, rounds)
    # the channel before the deep fades, which the port applies itself
    srv = jax.random.PRNGKey(ref.cfg.seed)
    out["channel"] = np.stack([np.asarray(sample_channel_gains(
        rsch.round_tag_key(srv, t, rsch.TAG_CHANNEL), K, ref.chan))
        for t in range(rounds)])
    key = jax.random.PRNGKey(FAST_SCHED["seed"])

    def u(r, fold=None):
        kr = rsch.round_tag_key(key, r, rsch.TAG_FAULT)
        if fold is not None:
            kr = jax.random.fold_in(kr, fold)
        return np.asarray(jax.random.uniform(kr, (K,)))

    out["fault_uniform"] = np.stack([u(r) for r in range(rounds + 1)])
    out["fade_uniform"] = np.stack([u(t, 1) for t in range(rounds)])
    return out


def port(data, transmit="delta", draws=None, **kw):
    x, y, parts = data
    clients = [tfl.FLClient(d, tloss, batch_size=32, lr=0.1, local_steps=2)
               for d in tbuild(x, y, parts)]
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, init_mlp_params(jax.random.PRNGKey(0))), device="cpu")
    if draws is not None:
        draws = tfl.ArrayDraws(device="cpu", **draws)
    return tfl.FusedPAOTA(params, clients, tcore.ChannelConfig(),
                          tcore.SchedulerConfig(**FAST_SCHED),
                          tfl.PAOTAConfig(transmit=transmit), device="cpu",
                          draws=draws, **kw)


def pair(data, transmit="delta", rounds=6, **kw):
    ref = reference(data, transmit, **kw)
    return ref, port(data, transmit, reference_draws(ref, rounds), **kw)


def assert_tracks(ref, prt, transmit):
    """Equal uploaders, screened rows, rollbacks and clocks every round;
    the globals at the fused tolerance."""
    for a, b in zip(ref.history, prt.history):
        for key in ("round", "time", "n_participants", "n_screened",
                    "rolled_back"):
            assert b[key] == a[key], (key, a["round"])
    assert np.isfinite(prt.global_vec).all()
    np.testing.assert_allclose(prt.global_vec, ref.global_vec,
                               **TOL[transmit])


# ---------------------------------------------------------------------------
# masks and injection on the same draws
# ---------------------------------------------------------------------------

FAULT_CASES = [dict(nan_frac=0.3, byzantine_frac=0.4, deep_fade_frac=0.5),
               dict(nan_frac=0.5, nan_mode="inf", start=2, stop=4,
                    deep_fade_frac=0.2),
               dict(byzantine_frac=1.0, byzantine_scale=3.0, start=1)]


@pytest.mark.parametrize("case", range(len(FAULT_CASES)))
def test_fault_masks_match_reference(case):
    fc = tsch.FaultConfig(**FAULT_CASES[case])
    key = jax.random.PRNGKey(5)
    for r in range(6):
        nm, bm = rsch.fault_payload_masks(key, r, K, _ref_faults(fc))
        fade = rsch.fault_channel_mask(key, r, K, _ref_faults(fc))
        kr = rsch.round_tag_key(key, r, rsch.TAG_FAULT)
        u = torch.from_numpy(np.array(jax.random.uniform(kr, (K,))))
        uf = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(kr, 1), (K,))))
        pnm, pbm = tsch.fault_payload_masks(u, r, fc)
        np.testing.assert_array_equal(pnm.numpy(), np.asarray(nm))
        np.testing.assert_array_equal(pbm.numpy(), np.asarray(bm))
        np.testing.assert_array_equal(
            tsch.fault_channel_mask(uf, r, fc).numpy(), np.asarray(fade))
        assert not (pnm & pbm).any()
        assert tsch.fault_active(fc, r) == bool(rsch.fault_active(
            _ref_faults(fc), r))


def test_blackout_window_matches_reference():
    """The pod-blackout window (which the port only reads to refuse a
    blackout, as the reference's single-device driver does)."""
    fc = tsch.FaultConfig(pod_blackout=(0, 2), blackout_start=2,
                          blackout_stop=5)
    assert fc.has_blackout and fc.any and not fc.has_payload_faults
    for r in range(7):
        assert tsch.blackout_active(fc, r) == bool(rsch.blackout_active(
            _ref_faults(fc), r))


@pytest.mark.parametrize("nan_mode", ["nan", "inf"])
@pytest.mark.parametrize("tree", [False, True], ids=["raveled", "pytree"])
def test_inject_payload_faults_matches_reference(nan_mode, tree):
    rng = np.random.default_rng(3)
    fc = tsch.FaultConfig(nan_frac=0.3, byzantine_frac=0.3,
                          byzantine_scale=-7.5, nan_mode=nan_mode)
    if tree:
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": rng.standard_normal((5,)).astype(np.float32)}
        tr = {k: (v[None] + 0.1 * rng.standard_normal((K,) + v.shape)
                  ).astype(np.float32) for k, v in g.items()}
    else:
        g = rng.standard_normal((17,)).astype(np.float32)
        tr = (g[None] + 0.1 * rng.standard_normal((K, 17))).astype(
            np.float32)
    nm = np.array([1, 0, 0, 1, 0, 0, 0, 0], bool)
    bm = np.array([0, 1, 0, 0, 0, 1, 1, 0], bool)
    want = rsch.inject_payload_faults(
        jax.tree_util.tree_map(jnp.asarray, tr),
        jax.tree_util.tree_map(jnp.asarray, g), jnp.asarray(nm),
        jnp.asarray(bm), _ref_faults(fc))
    got = tsch.inject_payload_faults(
        tree_map(torch.from_numpy, tr),
        tree_map(torch.from_numpy, g), torch.from_numpy(nm),
        torch.from_numpy(bm), fc)
    for w, p in zip(jax.tree_util.tree_leaves(want),
                    tree_leaves(got)):
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isnan(p.numpy()), np.isnan(w))
        np.testing.assert_array_equal(np.isinf(p.numpy()), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(p.numpy()[fin], w[fin], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("scaled", [False, True], ids=["f32", "int8"])
def test_compressed_round_factors_return_rho_then_theta(scaled):
    """The compressed cohort's stage 2 returns (rho, theta, w_norm2) in the
    reference's order: the screen reads theta, so a corrupt slot's NaN
    must land in theta, not in rho."""
    from repro.fl.runtime import compressed_round_factors as ref_factors
    rng = np.random.default_rng(9)
    m, s, d = 4, 6, 20
    vals = rng.standard_normal((m, s)).astype(np.float32)
    vals[2, 1] = np.nan
    idx = np.stack([rng.choice(d, s, replace=False)
                    for _ in range(m)]).astype(np.int32)
    resid = rng.standard_normal((m, s)).astype(np.float32)
    ridx = np.stack([rng.choice(d, s, replace=False)
                     for _ in range(m)]).astype(np.int32)
    g, pg = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    stal = np.asarray([0.0, 1.0, 2.0, 5.0], np.float32)
    scale = (rng.uniform(0.5, 2.0, m).astype(np.float32) if scaled
             else None)
    want = ref_factors(*(jnp.asarray(a) for a in (vals, idx, resid, ridx,
                                                  g, pg, stal)), 3.0,
                       scale=None if scale is None else jnp.asarray(scale))
    got = tfl.runtime.compressed_round_factors(
        *(torch.from_numpy(a) for a in (vals, idx, resid, ridx, g, pg,
                                        stal)), 3.0,
        scale=None if scale is None else torch.from_numpy(scale))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    rho, theta, _ = got
    assert torch.isfinite(rho).all() and not torch.isfinite(theta[2])


# ---------------------------------------------------------------------------
# the fused round's fault tests (tests/test_fault_round.py:79-256)
# ---------------------------------------------------------------------------

def test_identity_faultconfig_is_noop_fused(data):
    """A default FaultConfig with screening and rollback off is the plain
    round, row for row and bit for bit, and tracks the reference."""
    ref, plain = pair(data, rounds=3)
    draws = reference_draws(ref, 3)
    armed = port(data, draws=draws, faults=tsch.FaultConfig(), screen=False,
                 divergence_factor=0.0)
    ref.advance(3)
    for rp, ra in zip(plain.advance(3), armed.advance(3)):
        assert rp == ra
    np.testing.assert_array_equal(plain.global_vec, armed.global_vec)
    assert_tracks(ref, armed, "delta")


def _poisoned(drv, rows, mode):
    """Replace the driver's local training with one whose ``rows`` train
    NaN (``mode="nan"``), or a scenario that drops their uploads
    (``"drop"``)."""
    base = drv._streams
    if mode == "nan":
        sel = torch.tensor(rows)

        def train(g, r):
            tr = base.local_train(g, r).clone()
            tr[sel] = float("nan")
            return tr
        drv._streams = base._replace(local_train=train)
    else:
        drop = torch.zeros((K,), dtype=torch.bool)
        drop[rows] = True
        drv._streams = base._replace(
            scenario=lambda t: (torch.ones((K,), dtype=torch.bool), drop))


def test_screened_faulty_round_equals_dropped_uploads(data):
    """A round whose faulty clients are screened leaves a global bit-equal
    to the same round with those uploads dropped in transit; the screened
    run also tracks the reference's screened run."""
    ref = reference(data, screen=True)
    draws = reference_draws(ref, 4)
    base = ref._streams()

    def poisoned_train(g, x, y, r):
        tr = base.local_train(g, x, y, r)
        return jax.tree_util.tree_map(
            lambda l: l.at[jnp.array([1, 4])].set(jnp.nan), tr)

    ref._streams = lambda: base._replace(local_train=poisoned_train)
    screened = port(data, draws=draws, screen=True)
    _poisoned(screened, [1, 4], "nan")
    dropped = port(data, draws=draws)
    _poisoned(dropped, [1, 4], "drop")
    ref.advance(4)
    for rs, rd in zip(screened.advance(4), dropped.advance(4)):
        np.testing.assert_array_equal(screened.global_vec,
                                      dropped.global_vec)
        assert rs["time"] == rd["time"]
    assert sum(r["n_screened"] for r in screened.history) > 0
    assert all(r["n_screened"] == 0 for r in dropped.history)
    assert_tracks(ref, screened, "delta")


def test_nan_storm_unscreened_stalls_screened_progresses(data):
    storm = tsch.FaultConfig(nan_frac=0.9, start=1)
    ref_u, unscr = pair(data, faults=storm, rounds=5)
    unscr.advance(1)                      # round 0: faults not yet active
    g1 = np.array(unscr.global_vec, copy=True)
    unscr.advance(4)
    np.testing.assert_array_equal(unscr.global_vec, g1)
    assert np.isfinite(unscr.global_vec).all()
    ref_u.advance(5)
    assert_tracks(ref_u, unscr, "delta")

    ref_s, scr = pair(data, faults=storm, screen=True, rounds=5)
    scr.advance(1)
    s1 = np.array(scr.global_vec, copy=True)
    scr.advance(4)
    assert not np.array_equal(scr.global_vec, s1)     # kept converging
    assert np.isfinite(scr.global_vec).all()
    assert sum(r["n_screened"] for r in scr.history) > 0
    ref_s.advance(5)
    assert_tracks(ref_s, scr, "delta")


def test_byzantine_unscreened_corrupts_fence_contains(data):
    byz = tsch.FaultConfig(byzantine_frac=0.5, byzantine_scale=-50.0,
                           start=1)
    ref_c, clean = pair(data, "model")
    clean.advance(6)
    g_clean = np.array(clean.global_vec, copy=True)
    norm = float(np.linalg.norm(g_clean))

    ref_u, unscr = pair(data, "model", faults=byz)
    unscr.advance(6)
    dev_unscr = float(np.linalg.norm(unscr.global_vec - g_clean))
    assert np.isfinite(unscr.global_vec).all()
    assert float(np.linalg.norm(unscr.global_vec)) > 1.2 * norm
    assert dev_unscr > 0.5 * norm

    ref_f, fence = pair(data, "model", faults=byz, screen=True,
                        screen_max_norm=10.0)
    fence.advance(6)
    dev_fence = float(np.linalg.norm(fence.global_vec - g_clean))
    assert dev_fence < 0.15 * dev_unscr
    assert sum(r["n_screened"] for r in fence.history) > 0
    for ref, prt in ((ref_c, clean), (ref_u, unscr), (ref_f, fence)):
        ref.advance(6)
        assert_tracks(ref, prt, "model")


def test_rollback_restores_last_good_on_divergence(data):
    """Every round-3 local model scaled 100x: unguarded, w_g stays
    corrupted; with divergence_factor the detector fires once, at round
    3, and the run recovers, as the reference's does."""
    def blowup(drv):
        base = drv._streams

        def train(g, r):
            tr = base.local_train(g, r)
            return tr * 100.0 if r == 3 else tr
        drv._streams = base._replace(local_train=train)

    def ref_blowup(ref):
        base = ref._streams()

        def train(g, x, y, r):
            tr = base.local_train(g, x, y, r)
            s = jnp.where(jnp.asarray(r) == 3, jnp.float32(100.0),
                          jnp.float32(1.0))
            return jax.tree_util.tree_map(lambda l: l * s, tr)
        ref._streams = lambda: base._replace(local_train=train)

    _, clean = pair(data, "model")
    clean.advance(6)
    norm = float(np.linalg.norm(clean.global_vec))

    ref_b, bare = pair(data, "model")
    blowup(bare)
    ref_blowup(ref_b)
    bare.advance(6)
    n_bare = float(np.linalg.norm(bare.global_vec))
    assert np.isfinite(n_bare) and n_bare > 5.0 * norm

    ref_g, guard = pair(data, "model", divergence_factor=4.0)
    blowup(guard)
    ref_blowup(ref_g)
    guard.advance(6)
    rolled = [r["rolled_back"] for r in guard.history]
    assert sum(rolled) == 1.0 and rolled[3] == 1.0
    n_guard = float(np.linalg.norm(guard.global_vec))
    assert np.isfinite(n_guard) and n_guard < 2.0 * norm
    ref_g.advance(6)
    assert_tracks(ref_g, guard, "model")


# ---------------------------------------------------------------------------
# kill at round r + restore == the uninterrupted run
# ---------------------------------------------------------------------------

FAULTS = tsch.FaultConfig(nan_frac=0.25, byzantine_frac=0.25,
                          deep_fade_frac=0.2)


def _resume_roundtrip(make, tmp_path, n=4, r=2):
    """The full run against save at round r + a fresh driver's restore +
    the rest, bit for bit (counter draws)."""
    full = make()
    full.advance(n)
    part = make()
    part.advance(r)
    path = str(tmp_path / "kill.npz")
    part.save_checkpoint(path)
    res = make()                      # a fresh driver, never advanced
    assert res.restore_checkpoint(path) == r
    res.advance(n - r)
    np.testing.assert_array_equal(full.global_vec, res.global_vec)
    assert len(res.history) == n
    for rf, rr in zip(full.history, res.history):
        assert rf.keys() == rr.keys()
        for key in rf:                # NaN == NaN: a row may hold one
            np.testing.assert_array_equal(rr[key], rf[key])


def test_resume_bit_exact_fused_dense(data, tmp_path):
    _resume_roundtrip(
        lambda: port(data, faults=FAULTS, screen=True,
                     divergence_factor=4.0), tmp_path)


def test_resume_bit_exact_fused_compressed_cohort(data, tmp_path):
    _resume_roundtrip(
        lambda: port(data, faults=FAULTS, screen=True, cohort_size=4,
                     compress="topk", compress_ratio=0.25,
                     slot_dtype="int8"), tmp_path)


def test_checkpoint_every_saves_at_the_boundaries(data, tmp_path):
    """checkpoint_every=2 saves after rounds 2 and 4 of a 5-round advance
    and leaves the trajectory as it is; the round-4 file restores into a
    fresh driver that continues it bit for bit."""
    folder = tmp_path / "ckpt"
    plain = port(data, faults=FAULTS, screen=True)
    plain.advance(5)
    saving = port(data, faults=FAULTS, screen=True, checkpoint_every=2,
                  checkpoint_dir=str(folder))
    saving.advance(5)
    np.testing.assert_array_equal(plain.global_vec, saving.global_vec)
    names = sorted(p.name for p in folder.iterdir())
    assert names == ["round_000002.npz", "round_000004.npz"]
    res = port(data, faults=FAULTS, screen=True)
    assert res.restore_checkpoint(str(folder / names[-1])) == 4
    res.advance(1)
    np.testing.assert_array_equal(plain.global_vec, res.global_vec)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_checkpoint_passes_between_packages(data, tmp_path, first):
    """One package runs 5 rounds and saves; the other restores the file
    and runs 5 more on the reference's draws; the result matches the
    reference's straight 10 rounds at the fused tolerance. Faults,
    screening and rollback on, so the file carries the rollback slot."""
    kw = dict(faults=tsch.FaultConfig(nan_frac=0.2, deep_fade_frac=0.2),
              screen=True, divergence_factor=4.0)
    straight = reference(data, **kw)
    draws = reference_draws(straight, 10)
    straight.advance(10)
    path = str(tmp_path / "handoff.npz")
    if first == "reference":
        a, b = reference(data, **kw), port(data, draws=draws, **kw)
    else:
        a, b = port(data, draws=draws, **kw), reference(data, **kw)
    a.advance(5)
    a.save_checkpoint(path)
    assert b.restore_checkpoint(path) == 5
    b.advance(5)
    assert len(b.history) == 10
    for x, y in zip(straight.history, b.history):
        for key in ("round", "time", "n_participants", "n_screened",
                    "rolled_back"):
            assert y[key] == x[key], (key, x["round"])
    np.testing.assert_allclose(b.global_vec, straight.global_vec,
                               **TOL["delta"])
