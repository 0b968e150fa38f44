"""The port's sharded PAOTA round (``ShardedPAOTA`` over 4 gloo ranks on
the CPU) held against the reference's single-device ``FusedPAOTA`` on the
reference's own draws (``ArrayDraws``), K = 8 (and K = 10, padded to 12)
over 4 rounds of make_mnist_like(n_train=2000), as tests/test_fused_round.py.

The reference's own ``ShardedPAOTA`` is no oracle on this tree (its
multi-device tests fail in ``repro/fl/engine.py``), so the port is held to
the reference's equivalence contract instead: "the sharded trajectory is
allclose to FusedPAOTA round for round" (``src/repro/fl/sharded.py:83-91``)
at the reference's sharded-vs-fused tolerance, rtol 1e-4 / atol 1e-5
(``tests/test_sharded_round.py:53-57``); transmit='delta' at the port's
standing 5e-5 (``tests/test_torch_fused.py`` ``TOL``). Grouped N = 2 is
held to a per-pod composition of the reference's single-device stage
functions.

One group of 4 spawned ranks runs every case in turn
(``repro_torch.launch.sharded_cases.run_cases``) while this process runs
the reference; the ranks import no JAX.
"""
import signal
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ChannelConfig, SchedulerConfig  # noqa: E402
from repro.core.aggregation import (guarded_global_update,  # noqa: E402
                                    paota_finalize_stacked,
                                    paota_partial_stacked)
from repro.core.aircomp import sample_channel_gains  # noqa: E402
from repro.core.boxqp import waterfill_beta_jnp  # noqa: E402
from repro.core.power_control import (power_from_beta,  # noqa: E402
                                      staleness_factor)
from repro.core.scheduler import (TAG_CHANNEL, TAG_NOISE,  # noqa: E402
                                  counter_latencies, round_tag_key,
                                  sched_advance, sched_broadcast)
from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.pipeline import build_federation  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro.fl import FLClient, FusedPAOTA, PAOTAConfig  # noqa: E402
from repro.fl.runtime import constraint7_powers, round_factors  # noqa: E402
from repro.models.mlp import init_mlp_params, mlp_loss  # noqa: E402
from repro_torch.launch.mesh import start_ranks  # noqa: E402
from repro_torch.launch.sharded_cases import run_cases  # noqa: E402

R = 4
TOL = {"model": dict(rtol=1e-4, atol=1e-5),
       "delta": dict(rtol=1e-4, atol=5e-5)}
RANKS_TIMEOUT_S = 150
GUARD_S = 240           # the whole module fixture, ranks and reference


class _Guard:
    """A pytest-level limit on the module fixture: SIGALRM raises in the
    main thread after ``seconds`` (where the runner is not in the main
    thread, the ranks' own timeout is the limit)."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        self.armed = threading.current_thread() is threading.main_thread()
        if self.armed:
            def fire(*_):
                raise TimeoutError(f"sharded test fixture passed "
                                   f"{self.seconds} s")
            self.old = signal.signal(signal.SIGALRM, fire)
            signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        if self.armed:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self.old)


def _params():
    return init_mlp_params(jax.random.PRNGKey(0))


def _np_params():
    return jax.tree_util.tree_map(np.asarray, _params())


def _clients(x, y, parts):
    return [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
            for d in build_federation(x, y, parts)]


def _reference(x, y, parts, transmit, params_mode="raveled", **sched_kw):
    k = len(parts)
    sched = SchedulerConfig(n_clients=k, seed=1, **sched_kw)
    ref = FusedPAOTA(_params(), _clients(x, y, parts), ChannelConfig(),
                     sched, PAOTAConfig(transmit=transmit),
                     params_mode=params_mode)
    return ref, sched


def _draws(ref, sched):
    """The reference's draws for rounds 0..R (latencies, plans) and 0..R-1
    (channel, noise), as ArrayDraws arrays."""
    k = ref.k
    lat_key = jax.random.PRNGKey(sched.seed)
    srv = jax.random.PRNGKey(ref.cfg.seed)
    chan = ref.chan
    return {
        "latencies": np.stack([np.asarray(counter_latencies(
            lat_key, r, k, sched.lat_lo, sched.lat_hi))
            for r in range(R + 1)]),
        "channel": np.stack([np.asarray(sample_channel_gains(
            round_tag_key(srv, t, TAG_CHANNEL), k, chan)) for t in range(R)]),
        "noise": np.stack([np.asarray(chan.sigma_n * jax.random.normal(
            round_tag_key(srv, t, TAG_NOISE), (ref.d,)))
            for t in range(R)]),
        "batch_plan": np.stack([np.asarray(ref.engine.round_plan(r))
                                for r in range(R + 1)])}


def _trajectory(ref):
    """Per-round globals and rows of the reference, a round an advance."""
    globs, rows = [], []
    for _ in range(R):
        rows += ref.advance(1)
        globs.append(np.asarray(ref.global_vec).copy())
    return globs, rows


def _grouped_oracle(ref, sched, n_pods=2, period=2):
    """Grouped aggregation as a per-pod composition of the reference's
    single-device stage functions, on the reference's own streams (its
    engine trains on the replayed plans): pods own contiguous row blocks;
    a non-sync period water-fills per pod and holds the pod's partial
    weighted by rho(age); the sync water-fills over every row and
    finishes the summed partials with the round's noise."""
    st = ref._streams()
    x, y = ref.engine._x, ref.engine._y
    train = jax.jit(lambda g, r: st.local_train(g, x, y, r))
    rc = ref._rcfg
    k, rows = ref.k, ref.k // n_pods
    srv = jax.random.PRNGKey(ref.cfg.seed)
    g = prev = ref._init_global
    trained = train(g, jnp.int32(0))
    pending, deltas = trained, trained - g[None]
    ready = jnp.zeros((k,), bool)
    busy, model = st.latencies(0), jnp.zeros((k,), jnp.int32)
    held = [jnp.zeros((ref.d + 1,), jnp.float32) for _ in range(n_pods)]
    p_max = jnp.full((k,), rc.p_max_watts, jnp.float32)
    wf = jax.jit(waterfill_beta_jnp, static_argnames=("c1", "c0"))
    out = []
    for t in range(R):
        j = t % period
        ready, stal = sched_advance(ready, busy, model, jnp.int32(t),
                                    rc.delta_t)
        b = ready.astype(jnp.float32)
        stal = jnp.where(ready, stal, 0).astype(jnp.float32)
        rho, theta, w2 = round_factors(deltas, pending, g, prev, stal,
                                       rc.omega)
        if j == period - 1:
            beta, _ = wf(rho, theta, p_max, b, c1=rc.c1, c0=rc.c0)
        else:
            beta = jnp.concatenate([wf(
                rho[s], theta[s], p_max[s], b[s], c1=rc.c1, c0=rc.c0)[0]
                for s in (slice(i * rows, (i + 1) * rows)
                          for i in range(n_pods))])
        powers = power_from_beta(beta, rho, theta, p_max)
        powers = constraint7_powers(powers, pending, st.channel(t),
                                    rc.p_max_watts, w_norm2=w2)
        if j == period - 1:
            flat = paota_partial_stacked(pending, powers, b) + sum(held)
            agg, vs = paota_finalize_stacked(
                flat, pending, round_tag_key(srv, t, TAG_NOISE),
                ref.chan.sigma_n)
            g, prev = guarded_global_update(g, prev, agg, vs)
            held = [jnp.zeros_like(h) for h in held]
        else:
            w = jnp.float32(staleness_factor(float(period - 1 - j),
                                             rc.omega))
            for i in range(n_pods):
                s = slice(i * rows, (i + 1) * rows)
                held[i] = held[i] + w * paota_partial_stacked(
                    pending[s], powers[s], b[s])
        ready, busy, model = sched_broadcast(ready, busy, model, ready,
                                             st.latencies(t + 1),
                                             jnp.int32(t + 1))
        trained = train(g, jnp.int32(t + 1))
        sel = b[:, None] > 0
        pending = jnp.where(sel, trained, pending)
        deltas = jnp.where(sel, trained - g[None], deltas)
        out.append((np.asarray(g).copy(), int(b.sum())))
    return out


def _cases(draws8, draws10):
    base = dict(fed="k8", rounds=R, sched=dict(seed=1), draws=draws8,
                mesh=[("data", 4)], cfg=dict(transmit="model"))
    pods = [("pod", 2), ("data", 2)]
    pytree = dict(params_mode="pytree")
    bench = dict(n_clients=8, n_rounds=2, eval_every=1, local_steps=2,
                 engine="sharded")
    return [
        dict(base, name="flat_model"),
        dict(base, name="flat_delta", cfg=dict(transmit="delta")),
        dict(base, name="pytree_model", knobs=pytree),
        dict(base, name="phantoms", fed="k10", draws=draws10),
        dict(base, name="grouped_n1", mesh=pods,
             knobs=dict(group_period=1)),
        dict(base, name="grouped_n2", mesh=pods, step=2,
             knobs=dict(group_period=2)),
        dict(base, name="grouped_zero", mesh=pods, step=2, draws=None,
             rounds=6,
             sched=dict(seed=1, delta_t=8.0, lat_lo=30.0, lat_hi=40.0),
             knobs=dict(group_period=2)),
        dict(base, name="blackout", mesh=pods, step=2, rounds=6,
             draws=None, knobs=dict(group_period=2, faults=dict(
                 pod_blackout=(1,), blackout_start=2, blackout_stop=5))),
        dict(base, name="tp1", mesh=[("data", 4), ("tp", 1)], knobs=pytree),
        dict(base, name="tp2x2", mesh=[("data", 2), ("tp", 2)],
             knobs=pytree),
        dict(base, name="tp4", mesh=[("data", 1), ("tp", 4)], knobs=pytree),
        dict(name="waterfill", kind="waterfill", mesh=[("data", 4)],
             **_waterfill_inputs()),
        dict(base, name="refusals", kind="refusals", tries=[
            ("cohort_size", [("data", 4)], dict(cohort_size=4)),
            ("compress", [("data", 4)], dict(compress="topk")),
            ("checkpoint_every", [("data", 4)], dict(checkpoint_every=2)),
            ("tp_grouped", [("data", 2), ("tp", 2)],
             dict(params_mode="pytree", group_period=2)),
            ("tp_raveled", [("data", 2), ("tp", 2)], {}),
            ("blackout_flat", [("data", 4)], dict(faults=dict(
                pod_blackout=(1,), blackout_start=1, blackout_stop=2)))]),
        dict(name="allreduce", kind="allreduce", **_allreduce_inputs()),
        dict(name="harness_grouped", kind="harness",
             setting=dict(bench, group_period=2)),
        dict(name="harness_tp", kind="harness",
             setting=dict(bench, tp=2, params_mode="pytree")),
    ]


def _allreduce_inputs():
    """One payload a rank (a two-leaf tree), its power and ready bit, and
    the shared noise, for ``paota_allreduce`` / ``exact_average``."""
    rng = np.random.default_rng(4)

    def tree():
        return {"a": rng.standard_normal((3, 5)).astype(np.float32),
                "b": rng.standard_normal((7,)).astype(np.float32)}
    return dict(payloads=[tree() for _ in range(4)],
                powers=[1.5, 0.5, 2.0, 3.0], ready=[1.0, 0.0, 1.0, 1.0],
                weights=[1.0, 2.0, 3.0, 4.0],
                noise={k: 1e-3 * v for k, v in tree().items()})


def _waterfill_inputs():
    """The reference's sharded water-filling case (tests/
    test_sharded_round.py:150-167): K = 24, its inputs verbatim."""
    k = 24
    rng = np.random.default_rng(0)
    return dict(rho=rng.uniform(0.2, 1.0, k).astype(np.float32),
                theta=rng.uniform(0.0, 1.0, k).astype(np.float32),
                b=(rng.random(k) < 0.7).astype(np.float32),
                p_max=np.full(k, 15.0, np.float32), c1=8.0, c0=1e-4)


@pytest.fixture(scope="module")
def world():
    """Start the ranks on every case, run the reference meanwhile, and
    return (ranks' results, the reference's, wall seconds)."""
    t0 = time.perf_counter()
    with _Guard(GUARD_S):
        x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
        parts8 = partition_noniid(y, n_clients=8, seed=0)
        parts10 = partition_noniid(y, n_clients=10, seed=0)
        refs = {"model": _reference(x, y, parts8, "model")}
        draws8 = _draws(*refs["model"])
        ref10 = _reference(x, y, parts10, "model")
        draws10 = _draws(*ref10)
        spec = {"feds": {"k8": {"x": x, "y": y, "parts": parts8},
                         "k10": {"x": x, "y": y, "parts": parts10}},
                "params": _np_params(), "cases": _cases(draws8, draws10)}
        ranks = start_ranks(run_cases, 4, backend="gloo", device="cpu",
                            timeout_s=RANKS_TIMEOUT_S, threads=1,
                            args=(spec,))
        want = {"model": _trajectory(refs["model"][0]),
                "phantoms": _trajectory(ref10[0])}
        want["delta"] = _trajectory(_reference(x, y, parts8, "delta")[0])
        want["pytree"] = _trajectory(_reference(x, y, parts8, "model",
                                                "pytree")[0])
        # the oracle starts from the model run's w_g^0 and streams
        want["grouped"] = _grouped_oracle(*refs["model"])
        wf = _waterfill_inputs()
        beta, obj = waterfill_beta_jnp(
            jnp.asarray(wf["rho"]), jnp.asarray(wf["theta"]),
            jnp.asarray(wf["p_max"]), jnp.asarray(wf["b"]), wf["c1"],
            wf["c0"])
        want["waterfill"] = (np.asarray(beta), float(obj))
        got = ranks.wait()
    seconds = time.perf_counter() - t0
    print(f"\nsharded world: 4 gloo ranks + reference in {seconds:.1f} s")
    return got, want, seconds


def _same_on_every_rank(got, name):
    g0 = got[0][name]["globals"]
    return all(all(np.array_equal(a, b) for a, b in zip(r[name]["globals"],
                                                         g0))
               for r in got[1:])


def _model_sized(calls, d):
    return [c for c in calls if c[2] == d + 1]


@pytest.mark.parametrize("name,ref,tol", [
    ("flat_model", "model", "model"), ("flat_delta", "delta", "delta"),
    ("pytree_model", "pytree", "model"), ("phantoms", "phantoms", "model"),
    ("tp2x2", "pytree", "model")])
def test_sharded_tracks_fused_round_for_round(world, name, ref, tol):
    got, want, _ = world
    globs, rows = want[ref]
    mine = got[0][name]
    assert _same_on_every_rank(got, name)
    for r, (a, b) in enumerate(zip(mine["globals"], globs)):
        np.testing.assert_allclose(a, b, err_msg=f"round {r}", **TOL[tol])
    assert [r["n_participants"] for r in mine["rows"]] == [
        r["n_participants"] for r in rows]
    assert [r["time"] for r in mine["rows"]] == [r["time"] for r in rows]
    for a, b in zip(mine["rows"], rows):
        assert a["varsigma"] == pytest.approx(b["varsigma"], rel=5e-4)
    assert any(r["n_participants"] > 0 for r in mine["rows"])


def test_phantoms_pad_k_to_the_shard_count(world):
    got, _, _ = world
    assert [r["phantoms"]["k_pad"] for r in got] == [12] * 4
    assert [r["phantoms"]["offset"] for r in got] == [0, 3, 6, 9]
    # the last rank holds client 9 and two phantoms, never ready
    assert all(n <= 1 for n in got[3]["phantoms"]["restarted"])


@pytest.mark.parametrize("name", ["flat_model", "tp2x2"])
def test_one_model_sized_all_reduce_a_round(world, name):
    got, _, _ = world
    for rank in got:
        res = rank[name]
        for calls in res["calls"]:
            big = _model_sized(calls, res["d"])
            assert len(big) == 1 and big[0][4] == "superpose"
            assert big[0][1] == (("data", "tp") if name == "tp2x2"
                                 else ("data",))
            # everything else is small: the water-filling's grid (2 x 4096)
            # and scalars, the metrics, the TP stats (3 K_local + 1)
            assert all(c[2] <= 2 * 4096 for c in calls if c not in big)
            assert len(calls) == (66 if name == "tp2x2" else 65)


def test_grouped_one_cross_pod_all_reduce_a_window(world):
    got, _, _ = world
    res = got[0]["grouped_n2"]
    for calls in res["calls"]:
        big = _model_sized(calls, res["d"])
        cross = [c for c in big if "pod" in c[1]]
        assert len(cross) == 1 and cross[0][1] == ("pod", "data")
        assert [c[1] for c in big] == [("data",), ("pod", "data")]


def test_grouped_n1_is_flat_bit_for_bit(world):
    got, _, _ = world
    for rank in got:
        for a, b in zip(rank["grouped_n1"]["globals"],
                        rank["flat_model"]["globals"]):
            np.testing.assert_array_equal(a, b)


def test_grouped_n2_matches_per_pod_composition(world):
    got, want, _ = world
    assert _same_on_every_rank(got, "grouped_n2")
    mine = got[0]["grouped_n2"]
    oracle = want["grouped"]
    for w, g in enumerate(mine["globals"]):
        np.testing.assert_allclose(g, oracle[2 * w + 1][0],
                                   err_msg=f"window {w}", **TOL["model"])
    assert [r["n_participants"] for r in mine["rows"]] == [
        n for _, n in oracle]
    # the global holds through each window's non-sync period
    assert mine["rows"][0]["varsigma"] == 0.0


def test_zero_uploader_window_holds_global_bit_for_bit(world):
    got, _, _ = world
    flat0 = np.asarray(ravel_pytree(_params())[0])
    for rank in got:
        res = rank["grouped_zero"]
        assert [r["n_participants"] for r in res["rows"][:2]] == [0, 0]
        np.testing.assert_array_equal(res["globals"][0], flat0)
        # every latency is below 40 s: round 4 (t = 40 s) has uploads
        assert res["rows"][4]["n_participants"] > 0


def test_pod_blackout_darkens_its_pod(world):
    got, _, _ = world
    assert _same_on_every_rank(got, "blackout")
    for rank in got:
        res = rank["blackout"]
        pod = res["coords"]["pod"]
        # step 1 ends at round 3, inside [2, 5): pod 1 restarts nobody
        if pod == 1:
            assert res["restarted"][1] == 0
    # pod 0 stays lit and its clients keep restarting
    assert sum(sum(r["blackout"]["restarted"]) for r in got
               if r["blackout"]["coords"]["pod"] == 0) > 0


def test_tp_extent_1_is_flat_and_layouts_agree(world):
    got, _, _ = world
    for rank in got:
        for a, b in zip(rank["tp1"]["globals"],
                        rank["pytree_model"]["globals"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got[0]["tp4"]["globals"], got[0]["tp2x2"]["globals"]):
        np.testing.assert_allclose(a, b, **TOL["model"])
    assert _same_on_every_rank(got, "tp4")


def test_waterfill_over_ranks_matches_single_device(world):
    """The reference's sharded-vs-single-device tolerances (beta atol
    2e-3, objective rel 1e-5; tests/test_sharded_round.py:165-167); every
    rank takes the same branches, so the objective is one number."""
    got, want, _ = world
    beta = np.concatenate([r["waterfill"]["beta"] for r in got])
    objs = {r["waterfill"]["objective"] for r in got}
    assert len(objs) == 1
    np.testing.assert_allclose(beta, want["waterfill"][0], atol=2e-3)
    assert objs.pop() == pytest.approx(want["waterfill"][1], rel=1e-5)
    tags = [c[4] for c in got[0]["waterfill"]["calls"]]
    assert tags == (["waterfill_bracket", "waterfill_grid"]
                    + ["waterfill_refine"] * 60 + ["waterfill_objective"])


def test_refusals_name_their_knobs(world):
    got, _, _ = world
    msgs = got[0]["refusals"]
    for knob in ("cohort_size", "compress", "checkpoint_every"):
        assert msgs[knob].startswith("NotImplementedError")
        assert knob in msgs[knob] and "ShardedPAOTA" in msgs[knob]
    assert "group_period" in msgs["tp_grouped"]
    assert "intra-client TP" in msgs["tp_grouped"]
    assert "params_mode='raveled'" in msgs["tp_raveled"]
    assert "group_period" in msgs["blackout_flat"]


def test_harness_runs_the_sharded_engine(world):
    got, _, _ = world
    for name in ("harness_grouped", "harness_tp"):
        rows = got[0][name]
        assert [r["round"] for r in rows] == [0, 1]

        def same(rs):
            return [{k: v for k, v in r.items() if k != "wall_s"}
                    for r in rs]
        assert same(rows) == same(got[1][name])
        assert np.isfinite([r["loss"] for r in rows]).all()


def test_sharded_engine_outside_a_process_group_refuses():
    from repro_torch.bench.common import BenchSetting
    with pytest.raises(NotImplementedError, match="torch.distributed.run"):
        BenchSetting(engine="sharded", n_clients=8)


def test_ranks_import_no_jax_and_fit_the_budget(world):
    """The ranks load neither JAX nor the reference (``run_ranks`` fails a
    rank that does), and the module's fixture fits its budget."""
    got, _, seconds = world
    assert len(got) == 4
    assert seconds < GUARD_S


def test_paota_allreduce_and_exact_average_over_ranks(world):
    """One payload a rank: (sum b p w + n) / sum b p and the weighted mean,
    the same on every rank, one all-reduce for the weights and one a
    leaf (the reference's form)."""
    got, _, _ = world
    c = _allreduce_inputs()
    bp = np.array(c["powers"]) * np.array(c["ready"])
    w = np.array(c["weights"])
    for key in ("a", "b"):
        stack = np.stack([p[key] for p in c["payloads"]])
        want = (np.tensordot(bp, stack, 1) + c["noise"][key]) / bp.sum()
        mean = np.tensordot(w, stack, 1) / w.sum()
        for rank in got:
            np.testing.assert_allclose(rank["allreduce"]["paota"][key],
                                       want, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(rank["allreduce"]["exact"][key],
                                       mean, rtol=1e-5, atol=1e-6)
    assert got[0]["allreduce"]["calls"] == 6
