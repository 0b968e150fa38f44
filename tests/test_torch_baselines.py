"""The port's synchronous baselines (Local SGD, COTAF) and its paper driver
held against the reference: K = 8, make_mnist_like(n_train=2000), the
reference's params carried across, the numpy streams (selection, straggler
clock, epoch-cursor plans) bit-equal by construction, and COTAF's noise
replayed from the reference's split chain of PRNGKey(seed + 77)."""
import csv

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ChannelConfig, SchedulerConfig  # noqa: E402
from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.pipeline import build_federation  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro.fl import (COTAFServer, FLClient, LocalSGDServer,  # noqa: E402
                      SyncConfig)
from repro.models.mlp import init_mlp_params, mlp_loss  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
from repro_torch.data.pipeline import build_federation as tbuild  # noqa: E402
from repro_torch.models.mlp import mlp_loss as tloss  # noqa: E402
from repro_torch.models.mlp import params_from_jax  # noqa: E402

K = 8
R = 5


@pytest.fixture(scope="module")
def data():
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    return x, y, partition_noniid(y, n_clients=K, seed=0)


def _np_params():
    return jax.tree_util.tree_map(np.asarray,
                                  init_mlp_params(jax.random.PRNGKey(0)))


def _pair(data, cls_ref, cls_port, draws=None):
    x, y, parts = data
    sched = dict(n_clients=K, seed=2)
    cfg = dict(n_select=5, seed=3)
    ref_clients = [FLClient(d, mlp_loss, 32, 0.1, 5)
                   for d in build_federation(x, y, parts)]
    port_clients = [tfl.FLClient(d, tloss, 32, 0.1, 5)
                    for d in tbuild(x, y, parts)]
    ref_args = (init_mlp_params(jax.random.PRNGKey(0)), ref_clients,
                SchedulerConfig(**sched), SyncConfig(**cfg))
    port_args = (params_from_jax(_np_params(), device="cpu"), port_clients,
                 tcore.SchedulerConfig(**sched), tfl.SyncConfig(**cfg))
    if cls_ref is COTAFServer:
        return (cls_ref(*ref_args, ChannelConfig()),
                cls_port(*port_args, tcore.ChannelConfig(), device="cpu",
                         draws=draws))
    return cls_ref(*ref_args), cls_port(*port_args, device="cpu")


def _cotaf_normals(seed, d, n):
    key = jax.random.PRNGKey(seed + 77)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (d,))))
    return tfl.ArrayDraws(noise=np.stack(out), device="cpu")


@pytest.mark.parametrize("algo", ["local_sgd", "cotaf"])
def test_baseline_tracks_reference_over_5_rounds(data, algo):
    if algo == "local_sgd":
        ref, port = _pair(data, LocalSGDServer, tfl.LocalSGDServer)
    else:
        ref, port = _pair(data, COTAFServer, tfl.COTAFServer,
                          _cotaf_normals(3, 8070, R))
    assert port.global_vec.dtype == np.float64
    for _ in range(R):
        p, j = port.round(), ref.round()
        assert set(p) == set(j)
        assert (p["round"], p["time"], p["n_participants"]) == (
            j["round"], j["time"], j["n_participants"])
        if algo == "cotaf":
            assert p["alpha_t"] == pytest.approx(j["alpha_t"], rel=1e-5)
        np.testing.assert_allclose(port.global_vec, ref.global_vec,
                                   rtol=1e-5, atol=1e-6)
    assert port.global_params()["l1"]["w"].dtype == torch.float32
    assert port.time > 8.0 * R       # the straggler clock: max of 5 draws


def test_baselines_default_to_the_gpu(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, parts = data
    clients = [tfl.FLClient(d, tloss, 32, 0.1, 5)
               for d in tbuild(x, y, parts)]
    params = params_from_jax(_np_params(), device="cpu")
    sched, cfg = tcore.SchedulerConfig(n_clients=K), tfl.SyncConfig()
    with pytest.raises(RuntimeError, match="cuda"):
        tfl.LocalSGDServer(params, clients, sched, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tfl.COTAFServer(params, clients, sched, cfg, tcore.ChannelConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        tfl.PAOTAServer(params, clients, tcore.ChannelConfig(), sched,
                        tfl.PAOTAConfig())
    with pytest.raises(NotImplementedError, match="legacy"):
        tfl.LocalSGDServer(params, clients, sched,
                           tfl.SyncConfig(engine="legacy"), device="cpu")


def test_cli_matches_reference_driver(tmp_path, monkeypatch, capsys):
    """The port CLI at K = 8 for 4 rounds writes the reference's CSV
    columns, and its local_sgd accuracy rows are the reference
    run_algorithm's: PAOTA runs first in both and moves the shared epoch
    cursors alike (its broadcasts follow the numpy scheduler alone)."""
    from benchmarks.common import BenchSetting, build_world, run_algorithm
    from repro_torch.bench import common as tcommon
    from repro_torch.launch import fl_train
    monkeypatch.delenv("REPRO_BENCH_FULL", raising=False)
    monkeypatch.setattr(tcommon, "init_mlp_params",
                        lambda seed: params_from_jax(_np_params(),
                                                     device="cpu"))
    out = tmp_path / "fl.csv"
    fl_train.main(["--rounds", "4", "--clients", "8", "--device", "cpu",
                   "--out", str(out)])
    assert "=== cotaf === final acc" in capsys.readouterr().out
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["accuracy", "algo", "loss", "round",
                             "test_loss", "time", "wall_s"]
    assert [r["algo"] for r in rows] == (["paota"] * 3 + ["local_sgd"] * 3
                                         + ["cotaf"] * 3)

    s = BenchSetting(n_rounds=4, n_clients=8)
    clients, params, world = build_world(s)
    run_algorithm("paota", s, clients, params, world)
    want = run_algorithm("local_sgd", s, clients, params, world)
    got = [r for r in rows if r["algo"] == "local_sgd"]
    assert [(int(r["round"]), float(r["time"]), float(r["accuracy"]))
            for r in got] == [(w["round"], w["time"], w["accuracy"])
                              for w in want]


def test_cli_refuses_unported_engines_and_defaults_to_the_gpu(monkeypatch):
    from repro_torch.launch import fl_train
    for engine in ("legacy", "sharded"):
        with pytest.raises(NotImplementedError, match=engine):
            fl_train.main(["--engine", engine, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fl_train.main(["--rounds", "1"])
