"""The port's compressed cohort payloads against the reference: the
compression primitives bit for bit (top-k ties included), int8 stochastic
rounding on the same dither, the gather_superpose twin against the Pallas
kernel in interpret mode, the reference's twin and the f64 oracle, the
compressed round stats, and FusedPAOTA(compress=...) against the
reference's over 10 rounds on the same draws (m = 4 of K = 12)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import compress as jc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.aircomp_sum import gather_superpose_pallas  # noqa: E402
from repro.kernels.ref import gather_superpose_ref as jgs_ref  # noqa: E402
from repro.kernels.round_stats import compressed_round_stats  # noqa: E402
from repro_torch.core import compress as tc  # noqa: E402
from repro_torch.kernels import gather_superpose as tgs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import round_stats as trs  # noqa: E402

from test_torch_cohort import (M, STATE, TOL, assert_global_close,  # noqa: E402,E501
                               assert_metrics_close, data, drift, pair,
                               port, step_pair)

ROUNDS = 10


def _plane(seed, m, d, ties=True):
    """An (m, d) f32 plane with the ties MLP deltas have: exact zeros and
    values equal in magnitude with either sign."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, d)).astype(np.float32)
    if ties:
        a[:, ::7] = 0.0
        a[:, 1::5] = np.round(a[:, 1::5], 1)
        a[:, 2::11] = -a[:, 3::11][:, :a[:, 2::11].shape[1]]
    return a


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,d,s", [(1, 2, 1), (5, 1000, 37), (3, 48, 12),
                                   (4, 8070, 504)])
def test_compress_primitives_bit_equal(m, d, s):
    a = _plane(m * d + s, m, d)
    ji = jc.topk_support(jnp.asarray(a), s)
    ti = tc.topk_support(T(a), s)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jv, tv = jc.gather_rows(jnp.asarray(a), ji), tc.gather_rows(T(a), ti)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.scatter_rows(tv, ti, d).numpy(),
                                  np.asarray(jc.scatter_rows(jv, ji, d)))
    je = jc.ef_residual(jnp.asarray(a), ji, jv)
    te = tc.ef_residual(T(a), ti, tv)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # EF is exact bookkeeping: residual + transmitted == original
    np.testing.assert_array_equal((te + tc.scatter_rows(tv, ti, d)).numpy(),
                                  a)
    (jsv, jsi), (tsv, tsi) = jc.sparsify(je, s), tc.sparsify(te, s)
    np.testing.assert_array_equal(tsi.numpy(), np.asarray(jsi))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))


def test_topk_ties_go_to_the_lower_index():
    a = T([[0.5, -0.5, 0.25, 0.5, 0.0, -0.0, 0.0]])
    np.testing.assert_array_equal(tc.topk_support(a, 7).numpy(),
                                  [[0, 1, 3, 2, 4, 5, 6]])


@pytest.mark.parametrize("seed", range(4))
def test_int8_quantize_bit_equal_on_the_same_dither(seed):
    m, s = 4, 504
    v = _plane(seed, m, s, ties=False) * np.float32(1e-2)
    key = jax.random.PRNGKey(seed)
    jq, js = jc.quantize_int8_stochastic(jnp.asarray(v), key)
    u = np.asarray(jax.random.uniform(key, (m, s), jnp.float32))
    tq, ts = tc.quantize_int8_stochastic(T(v), T(u))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))
    # the residual against the dequantized values, as the reference's
    idx = tc.topk_support(T(v), s // 2)
    vh = tc.gather_rows(tc.dequantize_int8(tq, ts), idx)
    np.testing.assert_array_equal(
        tc.ef_residual(T(v), idx, vh).numpy(),
        np.asarray(jc.ef_residual(jnp.asarray(v), _to_jax(idx),
                                  _to_jax(vh))))


def _gs_inputs(dtype, with_scale, m=5, d=1000, s=37, masked=False):
    comp = _plane(11, m, d, ties=False)
    idx = tc.topk_support(T(comp), s)
    vals = tc.gather_rows(T(comp), idx)
    rng = np.random.default_rng(3)
    scale = None
    if dtype == "int8":
        u = rng.random((m, s), dtype=np.float32)
        vals, scale = tc.quantize_int8_stochastic(vals, T(u))
    else:
        vals = vals.to(getattr(torch, dtype))
        if with_scale:
            scale = T(rng.uniform(0.5, 2.0, m).astype(np.float32))
    bp = rng.uniform(0.1, 2.0, m).astype(np.float32)
    if masked:
        bp[1::2] = 0.0          # dead rows: masked garbage, weight 0
    noise = rng.standard_normal(d).astype(np.float32)
    return vals, idx, T(bp), T(noise), scale


def _to_jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("dtype,with_scale", [
    ("float32", False), ("float32", True), ("bfloat16", False),
    ("int8", True)])
def test_gather_superpose_twin_matches_reference(dtype, with_scale, masked):
    """The twin against the Pallas kernel in interpret mode, the
    reference's own twin and the f64 oracle, at the reference's tolerances
    (tests/test_compress.py:128-169): d not a multiple of block_d, m*s
    odd."""
    d = 1000
    vals, idx, bp, noise, scale = _gs_inputs(dtype, with_scale, d=d,
                                             masked=masked)
    agg, raw = tgs.gather_superpose_plain(vals, idx, bp, noise, d=d,
                                          scale=scale)
    jargs = (_to_jax(vals), _to_jax(idx), _to_jax(bp), _to_jax(noise))
    jk, jvs = gather_superpose_pallas(*jargs, d=d, scale=_to_jax(scale),
                                      block_d=256, block_n=64,
                                      interpret=True)
    jt, jts = jops.gather_superpose(*jargs, d=d, scale=_to_jax(scale))
    jr, _ = jgs_ref(*jargs, d, scale=_to_jax(scale))
    oracle, oraw = tref.gather_superpose_ref(vals, idx, bp, noise, d,
                                             scale=scale)
    # varsigma is the raw sum of b*p: the int8 scale does not leak in
    for want in (float(jvs), float(jts), float(oraw)):
        assert float(raw) == pytest.approx(want, rel=1e-6)
    for want in (jk, jt, jr, oracle):
        np.testing.assert_allclose(agg.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # ops routes a CPU tensor to the twin
    got, _ = tops.gather_superpose(vals, idx, bp, noise, d=d, scale=scale)
    np.testing.assert_array_equal(got.numpy(), agg.numpy())


def test_gather_superpose_masked_rows_contribute_nothing():
    m, d, s = 4, 300, 16
    comp = _plane(13, m, d, ties=False)
    idx = tc.topk_support(T(comp), s)
    vals = tc.gather_rows(T(comp), idx)
    bp = T(np.array([0.7, 0.0, 1.3, 0.0], np.float32))
    agg, vs = tgs.gather_superpose_plain(vals, idx, bp, torch.zeros(d), d=d)
    dense = tc.scatter_rows(vals, idx, d).numpy()
    np.testing.assert_allclose(agg.numpy(),
                               (0.7 * dense[0] + 1.3 * dense[2]) / 2.0,
                               rtol=1e-6, atol=1e-7)
    assert float(vs) == pytest.approx(2.0)


@pytest.mark.parametrize("case", ["values_rank", "idx_dtype", "idx_shape",
                                  "bp_shape", "noise_shape", "scale_dtype",
                                  "values_dtype", "zero_d", "devices"])
def test_gather_superpose_wrappers_raise_on_bad_inputs(case):
    vals, idx, bp, noise, _ = _gs_inputs("float32", False, d=50, m=3, s=4)
    kw = dict(d=50, scale=None)
    if case == "values_rank":
        vals = vals.reshape(-1)
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "idx_shape":
        idx = idx[:, :2].contiguous()
    elif case == "bp_shape":
        bp = bp[:2]
    elif case == "noise_shape":
        noise = noise[:10]
    elif case == "scale_dtype":
        kw["scale"] = torch.ones(3, dtype=torch.float64)
    elif case == "values_dtype":
        vals = vals.double()
    elif case == "zero_d":
        kw["d"] = 0
    else:
        bp = bp.to("meta")
    for fn in (tgs.gather_superpose_plain, tgs.gather_superpose_cuda):
        with pytest.raises((ValueError, TypeError)):
            fn(vals, idx, bp, noise, **kw)


def test_gather_superpose_cuda_refuses_cpu_tensors():
    vals, idx, bp, noise, _ = _gs_inputs("float32", False, d=50, m=3, s=4)
    before = tgs.launches
    with pytest.raises(ValueError, match="CUDA"):
        tgs.gather_superpose_cuda(vals, idx, bp, noise, d=50)
    assert tgs.launches == before


@pytest.mark.parametrize("m,d,want", [
    (64, 8070, (1024, 4)), (256, 1024 * 16, (1024, 8)), (1, 1, (64, 1)),
    (40, 65, (128, 2)), (3, 5000, (1024, 1)), (10**4, 10**6, (1024, 1))])
def test_gather_superpose_plan_fills_one_wave(m, d, want):
    """The kernel's grid: the widest stripe it takes (a multiple of 64 up
    to 1024, covering d), then row splits up to one wave of 132 SMs with a
    row per warp in each split."""
    stripe, splits = tgs.plan(m, d, 132)
    assert (stripe, splits) == want
    stripes = -(-d // stripe)
    assert stripe % 64 == 0 and stripe <= 1024 and stripes * stripe >= d
    assert splits == 1 or (stripes * splits <= 132
                           and -(-m // splits) >= tgs.WARPS)


@pytest.mark.parametrize("with_resid", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_compressed_round_stats_match_reference(with_resid, with_scale):
    """Against the reference's ``compressed_round_stats`` and against the
    dense stats of the scattered reconstructions
    (tests/test_compress.py:177-198's tolerances)."""
    m, d, s = 6, 500, 50
    comp = _plane(17, m, d, ties=False)
    idx = tc.topk_support(T(comp), s)
    vals = tc.gather_rows(T(comp), idx)
    resid = tc.ef_residual(T(comp), idx, vals)
    r_vals, r_idx = tc.sparsify(resid, s)
    scale = (T(np.random.default_rng(1).uniform(0.5, 2, m)
               .astype(np.float32)) if with_scale else None)
    g = np.random.default_rng(23).standard_normal(d).astype(np.float32)
    rv, ri = (r_vals, r_idx) if with_resid else (None, None)
    got = trs.compressed_round_stats(vals, idx, rv, ri, T(g), scale=scale)
    want = compressed_round_stats(
        _to_jax(vals), _to_jax(idx), _to_jax(rv), _to_jax(ri),
        jnp.asarray(g), scale=_to_jax(scale))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    sv = vals * (1 if scale is None else scale[:, None])
    dense_v = tc.scatter_rows(sv, idx, d).numpy().astype(np.float64)
    dense_r = (tc.scatter_rows(r_vals, r_idx, d).numpy().astype(np.float64)
               if with_resid else 0 * dense_v)
    np.testing.assert_allclose(got[0].numpy(), (dense_v + dense_r) @ g,
                               rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), (dense_v ** 2).sum(1),
                               rtol=1e-5)
    np.testing.assert_allclose(
        got[1].numpy(), (dense_v ** 2).sum(1) + (dense_r ** 2).sum(1),
        rtol=1e-5)
    # ops routes to the same plain function on every device
    for a, b in zip(tops.round_stats_compressed(vals, idx, rv, ri, T(g),
                                                scale=scale), got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kw", [
    dict(compress="randmask"),
    dict(compress="randmask", slot_dtype="bfloat16"),
    dict(compress="topk")],
    ids=["randmask-f32-ef", "randmask-bf16-ef", "topk-f32-ef"])
def test_compressed_rounds_track_reference(data, kw):
    """With the slice's own local SGD, on the reference's draws: the slot
    maps and the (K,) state plane bit-equal every round, slot_idx too
    where the support is replayed (randmask), and w_g and the metrics
    within the delta-mode round's tolerance every round
    (tests/test_torch_cohort.py TOL). A top-k row holds the reference's
    support as a set; its order follows the magnitudes, which the local
    SGD's ulp-level differences reorder where two nearly tie (ROADMAP
    Queue 3 item 2)."""
    ref, prt = pair(data, "delta", rounds=ROUNDS, cohort_size=M,
                    compress_ratio=0.25, **kw)
    fields = STATE + (("slot_idx",) if kw["compress"] == "randmask" else ())
    tol = TOL["delta"]
    for _ in range(ROUNDS):
        a, b = step_pair(ref, prt, fields)
        assert_metrics_close(a, b, tol)
        assert_global_close(ref, prt, tol)
        want = np.sort(np.asarray(ref._carry.slot_idx), axis=1)
        np.testing.assert_array_equal(
            np.sort(prt._carry.slot_idx.numpy(), axis=1), want)
    drift(f"compressed {kw}", ref, prt)
    same_idx = (prt._carry.slot_idx.numpy()
                == np.asarray(ref._carry.slot_idx)).mean()
    same_val = (prt._carry.deltas.float().numpy()
                == np.asarray(ref._carry.deltas).astype(np.float32)).mean()
    print(f"slot_idx positions equal {same_idx:.4f}, stored values "
          f"bit-equal {same_val:.4f}")
    assert tuple(prt._carry.deltas.shape) == (M, prt.compress_s)
    assert tuple(prt._carry.resid_val.shape) == (12, prt.compress_s)


@pytest.mark.parametrize("kw", [
    dict(compress="topk", slot_dtype="bfloat16"),
    dict(compress="randmask", slot_dtype="int8", error_feedback=False)],
    ids=["topk-bf16-ef", "randmask-int8-noef"])
def test_compressed_rounds_keep_the_state_plane_of_the_reference(data, kw):
    """bf16 top-k and int8 slots on the same draws over 10 rounds: the
    slot maps and the (K,) state plane stay bit-equal every round, and so
    does slot_idx where the support is replayed (randmask). Their w_g does
    not stay within the delta-mode tolerance: the bf16 rounding of a
    reordered support and the int8 floor turn the local SGD's ulp-level
    differences into one-step jumps (ROADMAP Queue 3 item 2; the drift
    prints with -s)."""
    fields = STATE + (("slot_idx",) if kw["compress"] == "randmask" else ())
    ref, prt = pair(data, "delta", rounds=ROUNDS, cohort_size=M,
                    compress_ratio=0.25, **kw)
    for _ in range(ROUNDS):
        step_pair(ref, prt, fields)
    drift(f"compressed {kw}", ref, prt)
    assert np.isfinite(prt.global_vec).all()
    assert prt._carry.slot_idx.dtype == torch.int32
    if kw.get("slot_dtype") == "int8":
        assert prt._carry.deltas.dtype == torch.int8
        assert prt._carry.slot_resid is None and prt._carry.resid_val is None


@pytest.mark.parametrize("scheme", ["topk", "randmask"])
def test_identity_compression_bit_identical(data, scheme):
    """s = d keeps every coordinate: the identity branch routes the dense
    stats and the sweep-2 superposition, and f32 error feedback carries
    exact zeros, so the run equals the uncompressed cohort bit for bit."""
    plain = port(data, "delta", cohort_size=M)
    ident = port(data, "delta", cohort_size=M, compress=scheme,
                 compress_ratio=1.0)
    assert ident.compress_s == ident.d
    for a, b in zip(plain.advance(8), ident.advance(8)):
        assert a == b
    np.testing.assert_array_equal(plain.global_vec, ident.global_vec)


def test_identity_compression_bf16_without_ef_keeps_bf16_rows(data):
    ident = port(data, "delta", cohort_size=M, compress="topk",
                 compress_ratio=1.0, slot_dtype="bfloat16",
                 error_feedback=False)
    rows = ident.advance(4)
    assert ident._carry.deltas.dtype == torch.bfloat16
    assert ident._carry.slot_resid is None
    assert any(r["n_participants"] > 0 for r in rows)
    assert np.isfinite(ident.global_vec).all()


@pytest.mark.parametrize("seed", range(4))
def test_ef_handoff_invariant_under_slot_permutation(data, seed):
    """The parked residuals index by client, not slot: one round from a
    mid-flight compressed carry and from the same carry with its slots
    permuted advance the (K,) state plane and the (K, s) parked planes
    bit-identically (tests/test_compress.py:229-256)."""
    from repro_torch.fl.runtime import paota_round_step
    srv = port(data, "delta", cohort_size=M, compress="topk",
               compress_ratio=0.25)
    srv.advance(3)
    carry = srv._carry
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(M))
    permuted = type(carry)(**{**carry.__dict__, **{
        f: getattr(carry, f)[perm] for f in (
            "slot_client", "slot_live", "deltas", "slot_idx", "slot_resid",
            "slot_resid_idx")}})
    with torch.no_grad():
        c1, o1 = paota_round_step(carry, rcfg=srv._rcfg,
                                  streams=srv._streams)
        c2, o2 = paota_round_step(permuted, rcfg=srv._rcfg,
                                  streams=srv._streams)
    for f in ("ready", "busy_lat", "model_round", "resid_val",
              "resid_idx"):
        np.testing.assert_array_equal(getattr(c1, f).numpy(),
                                      getattr(c2, f).numpy())
    live1 = set(c1.slot_client[c1.slot_live].tolist())
    assert live1 == set(c2.slot_client[c2.slot_live].tolist())
    np.testing.assert_allclose(c1.global_vec.numpy(), c2.global_vec.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert float(o1["n_participants"]) == float(o2["n_participants"])
