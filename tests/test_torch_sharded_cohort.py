"""The port's sharded active cohort (``ShardedPAOTA(cohort_size=,
compress=)`` over 4 gloo ranks on the CPU) held against the reference on
the reference's own draws (``ArrayDraws``), make_mnist_like(n_train=2000),
4 rounds:

* m = K (K = 8) against the reference's single-device dense
  ``FusedPAOTA``, the reference's own sharded-cohort contract
  (tests/test_cohort_round.py:183-199: participants equal, rtol 1e-4 /
  atol 1e-5; transmit='delta' at the port's standing 5e-5);
* m < K (K = 10 padded to 12, m = 8: 2 slots a rank, the last rank one
  live slot beside two phantom rows), uncompressed and randmask f32 with
  error feedback, against the reference's own ``init_cohort_carry(
  n_real=)`` and ``_cohort_round_step`` under ``jax.vmap(...,
  axis_name="data")`` over a leading shard axis, each shard on the
  reference's own per-shard streams (``repro.fl.sharded.ShardedPAOTA.
  _shard_streams``). The (K,) state plane and the slot maps are bit-equal
  every round and w_g is within tests/test_torch_cohort.py's ``TOL``. The
  reference's shard_map driver is no oracle on this tree (its
  multi-device tests fail in ``repro/fl/engine.py``); its round function
  under ``vmap`` with a named axis is, since ``waterfill_beta_jnp(
  axis_name=)`` and ``gather_superpose_psum`` reduce over a vmapped axis
  as over a mesh axis;
* identity compression bit-identical to the uncompressed sharded cohort
  (tests/test_cohort_round.py:327-337); topk int8 finite with uploaders;
* the partial entry's twin against ``gather_superpose_psum`` under
  ``vmap`` at 1e-5.

One group of 4 spawned ranks runs every case while this process runs the
reference; the ranks import no JAX.
"""
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro.fl.runtime import _cohort_round_step  # noqa: E402
from repro.fl.runtime import init_cohort_carry  # noqa: E402
from repro.fl.sharded import ShardedPAOTA as RefSharded  # noqa: E402
from repro.kernels.aircomp_sum import gather_superpose_psum  # noqa: E402
from repro.models.mlp import init_mlp_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import start_ranks  # noqa: E402
from repro_torch.launch.sharded_cases import run_cases  # noqa: E402
from test_torch_cohort import TOL, reference, reference_draws  # noqa: E402

R = 4
RANKS = 4
RANKS_TIMEOUT_S = 150
STATE = ("slot_client", "slot_live", "ready", "model_round", "busy_lat")
RATIO = 1 / 16


def _np_params():
    return jax.tree_util.tree_map(np.asarray,
                                  init_mlp_params(jax.random.PRNGKey(0)))


def _pad_engine(ref, n):
    """The reference's ShardedPAOTA phantom padding of its engine
    (src/repro/fl/sharded.py:317-340) on a single-device FusedPAOTA, and
    the extents its ``_shard_streams`` reads."""
    k = ref.k
    ref.k_pad = -(-k // n) * n
    ref.n_phantom = ph = ref.k_pad - k
    ref.k_local = ref.k_pad // n
    eng = ref.engine
    if ph:
        def pad0(a):
            return jnp.concatenate([jnp.asarray(a),
                                    jnp.zeros((ph,) + a.shape[1:], a.dtype)])
        eng._x, eng._y = pad0(eng._x), pad0(eng._y)
        eng._n_dev = jnp.concatenate(
            [eng._n_dev, jnp.ones((ph,), eng._n_dev.dtype)])


def vmap_oracle(ref, n, rounds):
    """The reference's sharded cohort round as a vmap over n shards of its
    own round functions: per round, (carry with a leading shard axis,
    outputs). ``ref`` is a single-device FusedPAOTA with the cohort knobs;
    its engine is padded here."""
    _pad_engine(ref, n)
    k, k_loc = ref.k, ref.k_local
    m_loc = ref.cohort_size // n
    rcfg = ref._rcfg
    eng = ref.engine
    xs = jnp.reshape(eng._x, (n, k_loc) + eng._x.shape[1:])
    ys = jnp.reshape(eng._y, (n, k_loc) + eng._y.shape[1:])
    offsets = jnp.arange(n, dtype=jnp.int32) * k_loc

    def init(off, x, y):
        return init_cohort_carry(
            ref._init_global, x, y,
            streams=RefSharded._shard_streams(ref, off), k=k_loc, m=m_loc,
            n_real=jnp.clip(jnp.int32(k) - off, 0, k_loc),
            pending_dtype=rcfg.pending_dtype,
            keep_pending=not rcfg.transmit_delta, rcfg=rcfg)

    def step(c, off, x, y):
        return _cohort_round_step(
            c, x, y, rcfg=rcfg, streams=RefSharded._shard_streams(ref, off),
            axis_name="data")

    carry = jax.jit(jax.vmap(init, axis_name="data"))(offsets, xs, ys)
    stepj = jax.jit(jax.vmap(step, axis_name="data"))
    out = []
    for _ in range(rounds):
        carry, o = stepj(carry, offsets, xs, ys)
        out.append((jax.tree_util.tree_map(np.asarray, carry),
                    {kk: np.asarray(v) for kk, v in o.items()}))
    return out


@pytest.fixture(scope="module")
def world():
    """Start the ranks on every case, run the references meanwhile, and
    return (ranks' results, the references', wall seconds)."""
    t0 = time.perf_counter()
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    data8 = (x, y, partition_noniid(y, n_clients=8, seed=0))
    data10 = (x, y, partition_noniid(y, n_clients=10, seed=0))
    refs = {
        # m = K: the dense reference's trajectory on the cohort's draws
        "full_model": reference(data8, "model", k=8, cohort_size=8),
        "full_delta": reference(data8, "delta", k=8, cohort_size=8),
        # m < K: the vmapped oracle
        "vmap_model": reference(data10, "model", k=10, cohort_size=8),
        "vmap_randmask": reference(data10, "delta", k=10, cohort_size=8,
                                   compress="randmask",
                                   compress_ratio=RATIO),
    }
    draws = {name: reference_draws(ref, R) for name, ref in refs.items()}
    base = dict(rounds=R, sched=dict(seed=1), mesh=[("data", RANKS)],
                state=True)
    d8 = dict(base, fed="k8")
    coh4 = dict(cohort_size=4)
    cases = [
        dict(d8, name="full_model", draws=draws["full_model"],
             cfg=dict(transmit="model"), knobs=dict(cohort_size=8)),
        dict(d8, name="full_delta", draws=draws["full_delta"],
             cfg=dict(transmit="delta"), knobs=dict(cohort_size=8)),
        dict(base, fed="k10", name="vmap_model", draws=draws["vmap_model"],
             cfg=dict(transmit="model"), knobs=dict(cohort_size=8)),
        dict(base, fed="k10", name="vmap_randmask",
             draws=draws["vmap_randmask"], cfg=dict(transmit="delta"),
             knobs=dict(cohort_size=8, compress="randmask",
                        compress_ratio=RATIO)),
        dict(d8, name="uncompressed", cfg=dict(transmit="delta"),
             knobs=coh4),
        dict(d8, name="identity", cfg=dict(transmit="delta"),
             knobs=dict(coh4, compress="randmask", compress_ratio=1.0)),
        dict(base, fed="k10", name="topk_int8", cfg=dict(transmit="delta"),
             knobs=dict(cohort_size=8, compress="topk",
                        compress_ratio=RATIO, slot_dtype="int8")),
    ]
    spec = {"feds": {"k8": {"x": x, "y": y, "parts": data8[2]},
                     "k10": {"x": x, "y": y, "parts": data10[2]}},
            "params": _np_params(), "cases": cases}
    ranks = start_ranks(run_cases, RANKS, backend="gloo", device="cpu",
                        timeout_s=RANKS_TIMEOUT_S, threads=1, args=(spec,))
    want = {}
    for tx in ("model", "delta"):
        dense = reference(data8, tx, k=8)
        want[f"full_{tx}"] = [(dense.advance(1)[0],
                               np.asarray(dense.global_vec).copy())
                              for _ in range(R)]
    for name in ("vmap_model", "vmap_randmask"):
        want[name] = vmap_oracle(refs[name], RANKS, R)
    got = ranks.wait()
    seconds = time.perf_counter() - t0
    print(f"\nsharded cohort world: 4 gloo ranks + reference in "
          f"{seconds:.1f} s")
    return got, want, seconds


def _same_on_every_rank(got, name):
    g0 = got[0][name]["globals"]
    return all(all(np.array_equal(a, b) for a, b in zip(r[name]["globals"],
                                                         g0))
               for r in got[1:])


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_full_cohort_matches_fused_dense(world, transmit):
    """m = K over 4 ranks (2 slots a rank) tracks the reference's dense
    fused round, participants equal."""
    got, want, _ = world
    name = f"full_{transmit}"
    assert _same_on_every_rank(got, name)
    mine = got[0][name]
    tol = TOL[transmit]
    for r, ((row, glob), g, mrow) in enumerate(zip(want[name],
                                                    mine["globals"],
                                                    mine["rows"])):
        assert mrow["n_participants"] == row["n_participants"], r
        np.testing.assert_allclose(g, glob, rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=f"round {r}")
    assert any(row["n_participants"] > 0 for row in mine["rows"])


@pytest.mark.parametrize("name,transmit", [("vmap_model", "model"),
                                           ("vmap_randmask", "delta")])
def test_sharded_cohort_matches_vmapped_reference(world, name, transmit):
    """m < K with phantom rows: each rank's state plane and slot maps
    bit-equal to its shard of the reference's vmapped round every round,
    the uploaders and w_g within TOL."""
    got, want, _ = world
    oracle = want[name]
    tol = TOL[transmit]
    assert _same_on_every_rank(got, name)
    for r, (carry, outs) in enumerate(oracle):
        for rank, res in enumerate(got):
            state = res[name]["state"][r]
            for f in STATE:
                np.testing.assert_array_equal(
                    state[f], getattr(carry, f)[rank],
                    err_msg=f"{f}, rank {rank}, round {r}")
        row = got[0][name]["rows"][r]
        assert row["n_participants"] == int(outs["n_participants"][0])
        assert row["varsigma"] == pytest.approx(
            float(outs["varsigma"][0]), rel=tol["varsigma"])
        np.testing.assert_allclose(got[0][name]["globals"][r],
                                   carry.global_vec[0], rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=f"round {r}")
    # the last rank holds client 9 and two phantoms: one live slot at most
    last = got[RANKS - 1][name]["state"]
    assert all(s["slot_live"].sum() <= 1 for s in last)
    assert all(row["n_participants"] <= 8 for row in got[0][name]["rows"])
    assert any(row["n_participants"] > 0 for row in got[0][name]["rows"])


def test_identity_compression_is_the_uncompressed_cohort_bit_for_bit(world):
    got, _, _ = world
    for rank in got:
        for a, b in zip(rank["identity"]["globals"],
                        rank["uncompressed"]["globals"]):
            np.testing.assert_array_equal(a, b)
        assert rank["identity"]["rows"] == rank["uncompressed"]["rows"]


def test_topk_int8_cohort_is_finite_with_uploaders(world):
    got, _, _ = world
    assert _same_on_every_rank(got, "topk_int8")
    res = got[0]["topk_int8"]
    assert np.isfinite(res["globals"][-1]).all()
    assert any(row["n_participants"] > 0 for row in res["rows"])
    assert all(row["n_participants"] <= 8 for row in res["rows"])
    assert res["compress_s"] == round(res["d"] * RATIO)


@pytest.mark.parametrize("name", ["vmap_randmask", "topk_int8"])
def test_one_model_sized_all_reduce_a_round(world, name):
    """The compressed cohort's superposition is one all-reduce of d + 1
    floats a round, with the water-filling's and the metrics' small ones
    (65 calls a round, as the flat dense round)."""
    got, _, _ = world
    for rank in got:
        res = rank[name]
        for calls in res["calls"]:
            big = [c for c in calls if c[2] == res["d"] + 1]
            assert len(big) == 1 and big[0][4] == "superpose"
            assert len(calls) == 65


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_partial_twin_matches_gather_superpose_psum_under_vmap(dtype):
    """Each shard's ``ops.gather_superpose_partial`` (the twin on the
    CPU), summed over the shards and finished as the port's
    ``paota_aggregate_compressed(reducer=)`` finishes it, against the
    reference's ``gather_superpose_psum`` under ``vmap`` with a named
    axis: the aggregate and varsigma within 1e-5."""
    n, m_loc, s, d = 4, 3, 37, 500
    rng = np.random.default_rng(5)
    idx = np.stack([rng.permutation(d)[:s] for _ in range(n * m_loc)]
                   ).astype(np.int32).reshape(n, m_loc, s)
    bp = (0.1 + 15 * rng.random((n, m_loc))).astype(np.float32)
    bp[:, 1] = 0.0
    noise = (2.8e-7 * rng.standard_normal(d)).astype(np.float32)
    scale = None
    if dtype == "int8":
        vals = rng.integers(-127, 128, (n, m_loc, s)).astype(np.int8)
        scale = (1e-4 + 1e-3 * rng.random((n, m_loc))).astype(np.float32)
        tv, jv = torch.from_numpy(vals), jnp.asarray(vals)
    else:
        v = (1e-2 * rng.standard_normal((n, m_loc, s))).astype(np.float32)
        tv = torch.from_numpy(v).to(getattr(torch, dtype))
        jv = jnp.asarray(tv.float().numpy()).astype(jnp.dtype(dtype))
    want, want_vs = jax.vmap(
        lambda v, i, b, sc: gather_superpose_psum(v, i, b, jnp.asarray(noise),
                                                  "data", d, scale=sc),
        axis_name="data")(jv, jnp.asarray(idx), jnp.asarray(bp),
                          None if scale is None else jnp.asarray(scale))
    flat = torch.zeros((d + 1,))
    for r in range(n):
        part = torch.empty((d + 1,))
        ops.gather_superpose_partial(
            tv[r].contiguous(), torch.from_numpy(idx[r]),
            torch.from_numpy(bp[r]), part, d=d,
            scale=None if scale is None else torch.from_numpy(scale[r]))
        flat += part
    vs = torch.clamp_min(flat[d], 1e-12)
    agg = (flat[:d] + torch.from_numpy(noise)) / vs
    for r in range(n):
        np.testing.assert_allclose(agg.numpy(), np.asarray(want[r]),
                                   rtol=1e-5, atol=1e-5)
        assert float(vs) == pytest.approx(float(want_vs[r]), rel=1e-5)


def test_partial_twin_writes_at_offset_and_refuses_a_short_buffer():
    """The twin writes its d sums at ``offset`` and Σ bp in the last slot,
    leaving the rest of the buffer as it was; a buffer without room
    before its last slot is refused."""
    from repro_torch.kernels import gather_superpose as gs
    v = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    idx = torch.tensor([[0, 2], [2, 1]], dtype=torch.int32)
    bp = torch.tensor([2.0, 0.5])
    out = torch.full((7,), -7.0)
    gs.gather_superpose_partial_plain(v, idx, bp, out, 2, d=3)
    np.testing.assert_array_equal(out.numpy(),
                                  [-7, -7, 2.0, 2.0, 4 + 1.5, -7, 2.5])
    with pytest.raises(ValueError, match="varsigma slot"):
        gs.gather_superpose_partial_plain(v, idx, bp, torch.empty(3), d=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gs.gather_superpose_partial_cuda(v, idx, bp, out, d=3)


def test_ranks_import_no_jax_and_fit_the_budget(world):
    got, _, seconds = world
    assert len(got) == RANKS
    assert seconds < 240


def test_compressed_aggregate_through_a_one_rank_reducer_is_the_fused_one():
    """``paota_aggregate_compressed(reducer=)`` (partial, all-reduce,
    finish) on a one-rank mesh, whose all-reduce is the identity, against
    the fused route on the same inputs (the twins on the CPU), int8 slots
    with scales and dead rows."""
    from repro_torch.core.aggregation import paota_aggregate_compressed
    from repro_torch.launch.collectives import Reducer
    from repro_torch.launch.mesh import Mesh
    rng = np.random.default_rng(2)
    m, s, d = 6, 40, 300
    idx = torch.from_numpy(np.stack([rng.permutation(d)[:s]
                                     for _ in range(m)]).astype(np.int32))
    v = torch.from_numpy(rng.integers(-127, 128, (m, s)).astype(np.int8))
    scale = torch.from_numpy((1e-3 * rng.random(m)).astype(np.float32))
    powers = torch.from_numpy((15 * rng.random(m)).astype(np.float32))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    noise = torch.from_numpy((1e-6 * rng.standard_normal(d))
                             .astype(np.float32))
    want, want_vs = paota_aggregate_compressed(v, idx, powers, mask, noise,
                                               d, scale=scale)
    got, got_vs = paota_aggregate_compressed(
        v, idx, powers, mask, noise, d, scale=scale,
        reducer=Reducer(Mesh((("data", 1),))))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-9)
    assert float(got_vs) == float(want_vs)
