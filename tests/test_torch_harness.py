"""The port's paper harness (``repro_torch.bench``: the Theorem-1 bound,
Fig. 3-4, Table I, the fixed-beta ablation, the partitioners) and its
paper driver's flags, held against the reference on the same inputs: K = 6
clients, 4 rounds, the reference's params carried across, the numpy
streams (partition, scheduler, selection, epoch cursors) bit-equal by
construction, and PAOTA's and COTAF's draws replayed from the reference's
split chains, as tests/test_torch_host.py and test_torch_baselines.py do.
Fixed seeds, no Hypothesis."""
import csv
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import benchmarks.common as rcommon  # noqa: E402
from repro.core import convergence as rconv  # noqa: E402
from repro.core.aircomp import ChannelConfig, sample_channel_gains  # noqa: E402
from repro.data import partition as rpart  # noqa: E402
from repro.models.mlp import init_mlp_params  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
from repro_torch.bench import common as tcommon  # noqa: E402
from repro_torch.core import convergence as tconv  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.models.mlp import params_from_jax  # noqa: E402

K, R, SELECT = 6, 4, 3
D = 8070
# the reference's fused-vs-host tolerance (tests/test_fused_round.py),
# which tests/test_torch_host.py holds the host path to
TOL = dict(rtol=1e-4, atol=1e-5)


def _np_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, init_mlp_params(jax.random.PRNGKey(seed)))


def _paota_draws(seed, n0, k, n):
    """The reference host server's draws: for the i-th aggregating round
    the channel key is split off PRNGKey(seed) first, then the noise key."""
    chan = ChannelConfig(n0_dbm_hz=n0)
    key = jax.random.PRNGKey(seed)
    ch, nz = [], []
    for _ in range(n):
        key, sub = jax.random.split(key)
        ch.append(np.asarray(sample_channel_gains(sub, k, chan)))
        key, sub = jax.random.split(key)
        nz.append(np.asarray(chan.sigma_n * jax.random.normal(
            sub, (D,), np.float32)))
    return tfl.ArrayDraws(channel=np.stack(ch), noise=np.stack(nz),
                          device="cpu")


def _cotaf_draws(seed, n):
    """COTAF's unit normals: the split chain of PRNGKey(seed + 77)."""
    key = jax.random.PRNGKey(seed + 77)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (D,))))
    return tfl.ArrayDraws(noise=np.stack(out), device="cpu")


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Both packages' harness at K = 6, 4 rounds, 3 synchronous
    participants; the port on the CPU with the reference's params and
    draws; each package's outputs in its own directory."""
    def from_env(cls, **kw):
        kw.update(n_clients=K, n_rounds=R, n_select=SELECT)
        return cls(**kw)
    monkeypatch.delenv("REPRO_BENCH_FULL", raising=False)
    for cls in (rcommon.BenchSetting, tcommon.BenchSetting):
        monkeypatch.setattr(cls, "from_env", classmethod(from_env))
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path / "port"))
    monkeypatch.setattr(tcommon, "init_mlp_params",
                        lambda seed: params_from_jax(_np_params(seed),
                                                     device="cpu"))
    run_algorithm = tcommon.run_algorithm

    def replayed(name, s, clients, params, data, seed_offset=0, *,
                 device=None, draws=None):
        if name == "paota":
            draws = _paota_draws(s.seed, s.n0_dbm_hz, s.n_clients,
                                 s.n_rounds)
        elif name == "cotaf":
            draws = _cotaf_draws(s.seed, s.n_rounds)
        return run_algorithm(name, s, clients, params, data, seed_offset,
                             device="cpu", draws=draws)
    monkeypatch.setattr(tcommon, "run_algorithm", replayed)
    return tmp_path


# ---------------------------------------------------------------------------
# the Theorem-1 bound and the partitioners: float64 / numpy, exact
# ---------------------------------------------------------------------------

BOUND_CASES = [dict(), dict(eta=0.002, local_steps=5, smooth_l=10.0,
                            delta=0.001, vartheta=0.5),
               dict(eta=0.005, zeta=2.0, sigma=0.3, epsilon=0.1),
               dict(eta=0.2)]           # 1 - 2 eta^2 M^2 L^2 < 0: A = inf


@pytest.mark.parametrize("kw", BOUND_CASES,
                         ids=["default", "contracting", "loose", "inf"])
def test_bound_terms_equal_reference_float64(kw):
    rc, tc = rconv.BoundConstants(**kw), tconv.BoundConstants(**kw)
    a = tconv.contraction_A(tc)
    assert a == rconv.contraction_A(rc)
    assert (a == np.inf) == (kw == dict(eta=0.2))
    rng = np.random.default_rng(3)
    alphas = rng.random(12)
    alphas /= alphas.sum()
    if a != np.inf:
        want = rconv.gap_G(rc, alphas, 4.2, model_dim=D, sigma_n2=1e-13)
        got = tconv.gap_G(tc, alphas, 4.2, model_dim=D, sigma_n2=1e-13)
        assert got == want
    g_terms = list(rng.random(5))
    np.testing.assert_array_equal(
        tconv.bound_trajectory(tc, g_terms, 2.5),
        rconv.bound_trajectory(rc, g_terms, 2.5))


def test_bound_constants_are_exported_from_core():
    import repro_torch.core as core
    assert core.BoundConstants is tconv.BoundConstants
    assert core.contraction_A(core.BoundConstants()) == \
        rconv.contraction_A(rconv.BoundConstants())
    from repro.configs.mlp_mnist import CONFIG as rcfg
    from repro_torch.configs.mlp_mnist import CONFIG as tcfg
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)


@pytest.mark.parametrize("seed,alpha", [(0, 0.3), (1, 0.05), (7, 1.0),
                                        (3, 0.1)])
def test_dirichlet_partition_and_stats_are_bit_equal(seed, alpha):
    y = np.random.default_rng(11).integers(0, 10, 3000).astype(np.int32)
    want = rpart.partition_dirichlet(y, n_clients=40, alpha=alpha,
                                     seed=seed)
    got = tpart.partition_dirichlet(y, n_clients=40, alpha=alpha, seed=seed)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert tpart.heterogeneity_stats(got, y) == \
        rpart.heterogeneity_stats(want, y)
    if alpha <= 0.1:
        assert min(len(p) for p in got) == 0      # clients left empty


# ---------------------------------------------------------------------------
# parse_faults
# ---------------------------------------------------------------------------

FAULT_SPECS = ["nan:0.05", "inf:0.1", "byz:0.1", "scale:-20", "fade:0.02",
               "gain:1e-3", "start:2", "stop:5", "pods:0|2,bstart:1,bstop:3",
               "bstart:1", "bstop:3", "nan:0.05,start:1",
               "byz:0.1,scale:-50,fade:0.02, gain:1e-4", "", "nan:0.1,,",
               "bogus:1", "nan:2", "nan:0.6,byz:0.6", "start", "pods:-1"]


def _outcome(parse, spec):
    try:
        fc = parse(spec)
    except Exception as e:     # noqa: BLE001 -- compared by type and text
        return ("error", type(e).__name__, str(e))
    return None if fc is None else dataclasses.asdict(fc)


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_parse_faults_matches_reference(spec):
    assert _outcome(tcommon.parse_faults, spec) == \
        _outcome(rcommon.parse_faults, spec)


def test_parse_faults_covers_every_key():
    assert tcommon._FAULT_KEYS == rcommon._FAULT_KEYS
    keys = {part.strip().partition(":")[0] for spec in FAULT_SPECS
            for part in spec.split(",") if part.strip()}
    assert set(rcommon._FAULT_KEYS) <= keys


# ---------------------------------------------------------------------------
# bound, Fig. 3-4, Table I
# ---------------------------------------------------------------------------

def _numbers(derived):
    """``k=v;...`` -> {k: float or str}."""
    out = {}
    for part in derived.split(";"):
        k, _, v = part.partition("=")
        try:
            out[k] = float(v.rstrip("%"))
        except ValueError:
            out[k] = v
    return out


def test_bound_rows_match_reference():
    from benchmarks import bound as rbound
    from repro_torch.bench import bound as tbound
    want, got = rbound.run(), tbound.run(device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        gn, wn = _numbers(g["derived"]), _numbers(w["derived"])
        assert set(gn) == set(wn)
        for k in wn:
            if isinstance(wn[k], float):
                assert gn[k] == pytest.approx(wn[k], rel=1e-6), (g, k)
            else:
                assert gn[k] == wn[k]


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _no_wall(row):
    return {k: v for k, v in row.items() if k != "wall_s"}


_CSV = {"fig3": "fig3_trajectories.csv", "fig4": "fig4_trajectories.csv",
        "table1": "table1.csv"}


@pytest.mark.parametrize("module", ["fig3", "fig4", "table1"])
def test_paper_module_matches_reference(small, monkeypatch, module):
    """Same row names and CSV columns; baseline rows equal, PAOTA's round
    and time columns equal and its loss and accuracy at the host
    tolerance."""
    import importlib
    ref = importlib.import_module(f"benchmarks.{module}")
    port = importlib.import_module(f"repro_torch.bench.{module}")
    monkeypatch.setattr(ref, "OUT_DIR", str(small / "ref"))
    want, got = ref.run(), port.run(device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    w_csv = _read(small / "ref" / _CSV[module])
    g_csv = _read(small / "port" / _CSV[module])
    assert list(g_csv[0]) == list(w_csv[0])
    assert len(g_csv) == len(w_csv)
    for g, w in zip(g_csv, w_csv):
        if module == "table1" or g["algo"] != "paota":
            assert _no_wall(g) == _no_wall(w)
            continue
        for col in ("algo", "round", "time", "n0_dbm_hz"):
            assert g.get(col) == w.get(col)
        for col in ("loss", "accuracy", "test_loss"):
            np.testing.assert_allclose(float(g[col]), float(w[col]), **TOL,
                                       err_msg=f"{module} paota {col}")
    for g, w in zip(got, want):
        if g["name"].split("_")[1] != "paota":
            assert g["derived"] == w["derived"]
    if module == "table1":
        assert len(g_csv) == 3 * 4              # algorithms x targets
    else:
        assert max(float(r["accuracy"]) for r in g_csv) > 0.1


# ---------------------------------------------------------------------------
# the fixed-beta ablation
# ---------------------------------------------------------------------------

def _ablation_federation(port):
    from repro.data.partition import partition_noniid
    from repro.data.synthetic import make_mnist_like
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    parts = partition_noniid(y, n_clients=K, seed=0)
    if port:
        from repro_torch.data.pipeline import build_federation
        from repro_torch.models.mlp import mlp_loss
        return [tfl.FLClient(d, mlp_loss, 32, 0.1, 5)
                for d in build_federation(x, y, parts)]
    from repro.data.pipeline import build_federation
    from repro.fl import FLClient
    from repro.models.mlp import mlp_loss
    return [FLClient(d, mlp_loss, 32, 0.1, 5)
            for d in build_federation(x, y, parts)]


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
def test_fixed_beta_server_matches_reference(beta):
    from benchmarks.ablation import _FixedBetaServer as RefFixed
    from repro.core import SchedulerConfig
    from repro.fl import PAOTAConfig
    import repro_torch.core as tcore
    from repro_torch.bench.ablation import _FixedBetaServer
    chan = ChannelConfig(n0_dbm_hz=-74.0)
    ref = RefFixed(init_mlp_params(jax.random.PRNGKey(0)),
                   _ablation_federation(False), chan,
                   SchedulerConfig(n_clients=K, seed=0), PAOTAConfig(),
                   beta=beta)
    port = _FixedBetaServer(params_from_jax(_np_params(), device="cpu"),
                            _ablation_federation(True),
                            tcore.ChannelConfig(n0_dbm_hz=-74.0),
                            tcore.SchedulerConfig(n_clients=K, seed=0),
                            tfl.PAOTAConfig(), beta=beta, device="cpu",
                            draws=_paota_draws(0, -74.0, K, R))
    for _ in range(R):
        p, j = port.round(), ref.round()
        assert (p["round"], p["time"], p["n_participants"]) == (
            j["round"], j["time"], j["n_participants"])
        if p["n_participants"]:
            assert p["beta_mean"] == beta == j["beta_mean"]
        np.testing.assert_allclose(port.global_vec, ref.global_vec, **TOL)
    assert any(h["n_participants"] for h in port.history)


def test_fixed_beta_server_restores_solve_p2_after_a_raising_round(
        monkeypatch):
    import repro_torch.core as tcore
    from repro_torch.bench.ablation import _FixedBetaServer
    from repro_torch.fl import server as srv_mod
    orig = srv_mod.solve_p2
    srv = _FixedBetaServer(params_from_jax(_np_params(), device="cpu"),
                           _ablation_federation(True), tcore.ChannelConfig(),
                           tcore.SchedulerConfig(n_clients=K),
                           tfl.PAOTAConfig(), beta=0.5, device="cpu")
    seen = []

    def boom():
        seen.append(srv_mod.solve_p2)
        raise RuntimeError("round failed")
    monkeypatch.setattr(srv, "_round", boom)
    with pytest.raises(RuntimeError, match="round failed"):
        srv.round()
    assert seen and seen[0] is not orig
    assert srv_mod.solve_p2 is orig


# ---------------------------------------------------------------------------
# the paper driver's repaired and added flags
# ---------------------------------------------------------------------------

def _cli(argv, tmp_path, name="fl.csv"):
    from repro_torch.launch import fl_train
    out = tmp_path / name
    fl_train.main(list(argv) + ["--device", "cpu", "--out", str(out)])
    return _read(out)


class _Recorder:
    """Records the FusedPAOTA drivers the harness builds."""

    def __init__(self, monkeypatch):
        self.made = []
        rec = self

        class Recording(tfl.FusedPAOTA):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.made.append(self)
        monkeypatch.setattr(tcommon, "FusedPAOTA", Recording)


def test_cli_compress_alone_switches_to_delta_at_one_sixteenth(
        tmp_path, monkeypatch, capsys):
    """--compress topk without --transmit runs PAOTA's delta payload at
    s = round(d / 16), the reference's default ratio; an explicit
    --transmit model with it stays refused."""
    monkeypatch.delenv("REPRO_BENCH_FULL", raising=False)
    rec = _Recorder(monkeypatch)
    rows = _cli(["--rounds", "2", "--clients", "4", "--engine", "fused",
                 "--cohort-size", "2", "--compress", "topk"], tmp_path)
    assert "transmit=delta" in capsys.readouterr().out
    (drv,) = rec.made
    assert drv._rcfg.transmit_delta and drv.compress == "topk"
    assert drv.compress_s == round(D / 16) == 504
    assert {r["algo"] for r in rows} == {"paota", "local_sgd", "cotaf"}
    with pytest.raises(ValueError, match="compress rides transmit='delta'"):
        _cli(["--rounds", "1", "--clients", "4", "--engine", "fused",
              "--cohort-size", "2", "--compress", "topk", "--transmit",
              "model"], tmp_path)


def test_cli_faults_write_only_paota_rows(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_BENCH_FULL", raising=False)
    rec = _Recorder(monkeypatch)
    rows = _cli(["--rounds", "3", "--clients", "4", "--engine", "fused",
                 "--faults", "nan:0.3,start:1", "--screen",
                 "--divergence-factor", "4"], tmp_path)
    assert rows and {r["algo"] for r in rows} == {"paota"}
    (drv,) = rec.made
    assert drv.faults.nan_frac == 0.3 and drv.faults.start == 1
    assert drv._rcfg.screen and drv._rcfg.divergence_factor == 4.0
    assert np.isfinite([float(r["loss"]) for r in rows]).all()


@pytest.mark.parametrize("argv,error,match", [
    (["--faults", "nan:0.1"], ValueError, "--engine fused"),
    (["--screen"], ValueError, "--engine fused"),
    (["--engine", "fused", "--faults", "pods:0|1,bstart:1,bstop:2"],
     NotImplementedError, "grouped sharded"),
    (["--group-period", "2"], NotImplementedError, "group_period"),
    (["--tp", "2"], NotImplementedError, "tp=2")],
    ids=["faults", "screen", "pods", "group_period", "tp"])
def test_cli_refusals(tmp_path, monkeypatch, argv, error, match):
    monkeypatch.delenv("REPRO_BENCH_FULL", raising=False)
    with pytest.raises(error, match=match):
        _cli(["--rounds", "1", "--clients", "4"] + argv, tmp_path)


def test_cli_checkpoint_then_resume_equals_the_straight_run(tmp_path,
                                                             monkeypatch):
    monkeypatch.delenv("REPRO_BENCH_FULL", raising=False)
    rec = _Recorder(monkeypatch)
    ckpt = tmp_path / "ckpt"
    straight = _cli(["--rounds", "4", "--clients", "4", "--engine", "fused",
                     "--checkpoint-every", "2", "--checkpoint-dir",
                     str(ckpt)], tmp_path, "straight.csv")
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "round_000002.npz", "round_000004.npz"]
    resumed = _cli(["--rounds", "2", "--clients", "4", "--engine", "fused",
                    "--resume", str(ckpt / "round_000002.npz")], tmp_path,
                   "resumed.csv")
    first, second = rec.made
    np.testing.assert_array_equal(second.global_vec, first.global_vec)
    assert second.history == first.history

    assert [_no_wall(r) for r in resumed] == [
        _no_wall(r) for r in straight if int(r["round"]) >= 2]
    assert [int(r["round"]) for r in resumed] == [2, 3]


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_cpu_and_defaults_to_the_gpu(monkeypatch,
                                                        capsys):
    """The quickstart's 20 clients, cut to 6 of its 15 rounds."""
    from repro_torch.launch import quickstart
    monkeypatch.setattr(quickstart, "N_ROUNDS", 6)
    rows = quickstart.main(["--device", "cpu"])
    assert [r[0] for r in rows] == [2, 5]
    assert all(0.0 <= r[1] <= 1.0 and 0.0 <= r[3] <= 1.0 for r in rows)
    assert rows[-1][2] == pytest.approx(8.0 * 6)      # PAOTA: 6 x delta_t
    assert rows[-1][4] > rows[-1][2] / 2
    assert "Fig. 4 / Table I" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])
