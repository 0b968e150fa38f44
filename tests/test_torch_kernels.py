"""Port kernels, CPU side: the plain-torch twins of the two delta-plane
sweeps, of aircomp_sum and of the cosine partials held against the
reference's Pallas kernels (interpret mode) and the float64 oracles, plus
the wrappers' input checks. The CUDA kernels
themselves are held against the same twins on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import power_control as jpc  # noqa: E402
from repro.kernels.aircomp_sum import (aircomp_sum_pallas,  # noqa: E402
                                       superpose_normalize_pallas)
from repro.kernels.cosine_sim import cosine_partials_pallas  # noqa: E402
from repro.kernels.round_stats import round_stats_pallas  # noqa: E402
from repro_torch.core import power_control as tpc  # noqa: E402
from repro_torch.kernels import aircomp_sum, ops, ref  # noqa: E402
from repro_torch.kernels import cosine_sim as cs  # noqa: E402
from repro_torch.kernels import round_stats as rs  # noqa: E402

RNG = np.random.default_rng(11)
SHAPES = [(1, 1), (3, 511), (8, 8070), (100, 8070)]


def _tol(dtype):
    """The reference's kernel tolerances (tests/test_kernels.py:16-17);
    stats sums of O(D) terms take its round-stats atol
    (tests/test_round_stats.py:16)."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=3e-5, atol=3e-4))


def _pair(a, dtype):
    """The same values as a jnp array and a torch tensor (bf16 through
    uint16 bit patterns: torch.from_numpy rejects ml_dtypes)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    if dtype == "bfloat16":
        bits = np.asarray(j).view(np.uint16).astype(np.int16)
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, torch.from_numpy(np.array(j))


@pytest.mark.parametrize("k,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_payload", [False, True])
def test_round_stats_twin_matches_pallas_and_oracle(k, d, dtype,
                                                    with_payload):
    dj, dt = _pair(0.1 * RNG.normal(size=(k, d)), dtype)
    gj, gt = _pair(RNG.normal(size=d), "float32")
    pj, pt = (_pair(RNG.normal(size=(k, d)), dtype) if with_payload
              else (None, None))
    want, want_g = round_stats_pallas(dj, gj, pj, interpret=True)
    got, got_g = rs.round_stats_plain(dt, gt, pt)
    oracle, oracle_g = ref.round_stats_ref(dt, gt, pt)
    assert got.shape == (k, 3 if with_payload else 2)
    assert got.dtype == torch.float32 and got_g.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **_tol(dtype))
    assert float(got_g) == pytest.approx(float(want_g), rel=3e-5)
    assert float(got_g) == pytest.approx(float(oracle_g), rel=3e-5)


def _mask(kind, k):
    if kind == "zero":
        return np.zeros(k, np.float32)
    if kind == "one":
        m = np.zeros(k, np.float32)
        m[k // 2] = 1.0
        return m
    if kind == "full":
        return np.ones(k, np.float32)
    return (RNG.random(k) < 0.5).astype(np.float32)


@pytest.mark.parametrize("k,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", ["zero", "one", "partial", "full"])
def test_superpose_twin_matches_pallas_and_oracle(k, d, dtype, mask_kind):
    xj, xt = _pair(RNG.normal(size=(k, d)), dtype)
    pj, pt = _pair(RNG.uniform(0.1, 15.0, k), "float32")
    mj, mt = _pair(_mask(mask_kind, k), "float32")
    nj, nt = _pair(1e-3 * RNG.normal(size=d), "float32")
    want, want_vs = superpose_normalize_pallas(xj, pj, mj, nj, vs_min=1e-12,
                                               interpret=True)
    got, got_vs = aircomp_sum.superpose_normalize_plain(xt, pt, mt, nt,
                                                        vs_min=1e-12)
    oracle, oracle_vs = ref.superpose_normalize_ref(xt, pt, mt, nt)
    assert got.shape == (d,) and got.dtype == torch.float32
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **tol)
    assert float(got_vs) == pytest.approx(float(want_vs), rel=3e-5)
    assert float(got_vs) == pytest.approx(float(oracle_vs), rel=3e-5)
    if mask_kind == "zero":
        # nothing superposed: raw varsigma is exactly 0 and the aggregate
        # is the noise over the clamp
        assert float(got_vs) == 0.0
        np.testing.assert_array_equal(got.numpy(), (nt / 1e-12).numpy())


# tests/test_kernels.py:20's aircomp_sum shapes
AIRCOMP_SHAPES = [(4, 64), (37, 1111), (100, 8070), (1, 513)]


@pytest.mark.parametrize("k,d", AIRCOMP_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", ["zero", "one", "partial", "full"])
def test_aircomp_sum_twin_matches_pallas_and_oracle(k, d, dtype, mask_kind):
    """bp = powers * mask arrives already masked; masked rows add nothing."""
    xj, xt = _pair(RNG.normal(size=(k, d)), dtype)
    bp = RNG.random(k) * _mask(mask_kind, k)
    bj, bt = _pair(bp, "float32")
    nj, nt = _pair(RNG.normal(size=d), "float32")
    want = aircomp_sum_pallas(xj, bj, nj, interpret=True)
    got = aircomp_sum.aircomp_sum_plain(xt, bt, nt)
    oracle = ref.aircomp_sum_ref(xt, bt, nt)
    assert got.shape == (d,) and got.dtype == torch.float32
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=3e-5, atol=3e-5)
    if mask_kind == "zero":     # noise / 1e-12: compare relatively
        tol = dict(rtol=3e-5, atol=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **tol)


def test_aircomp_sum_twin_keeps_bf16_payload_f32_aggregate():
    """tests/test_kernels.py:32's regression: a bf16 payload comes back as
    an f32 aggregate with the f32 noise joining the f32 sum un-rounded."""
    x32 = RNG.normal(size=(24, 1111)).astype(np.float32)
    xj, xt = _pair(x32, "bfloat16")
    bj, bt = _pair(RNG.random(24), "float32")
    nj, nt = _pair(RNG.normal(size=1111), "float32")
    got = aircomp_sum.aircomp_sum_plain(xt, bt, nt)
    assert got.dtype == torch.float32
    want = np.asarray(aircomp_sum_pallas(xj, bj, nj, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    oracle = ref.aircomp_sum_ref(xt.float(), bt, nt)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_partials_twin_matches_pallas_and_oracle(k, d, dtype):
    dj, dt = _pair(0.1 * RNG.normal(size=(k, d)), dtype)
    gj, gt = _pair(RNG.normal(size=d), "float32")
    want = cosine_partials_pallas(dj, gj, interpret=True)
    got = cs.cosine_partials_plain(dt, gt)
    oracle = ref.cosine_partials_ref(dt, gt)
    assert got.shape == (k, 2) and got.dtype == torch.float32
    tol = (_tol(dtype) if dtype == "bfloat16"
           else dict(rtol=3e-5, atol=3e-4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **tol)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cosine_similarity_matches_reference(use_kernel):
    """Both routes of cosine_similarity, each against the reference's
    same route (their finishing clamps differ), including a zero row and
    a zero direction."""
    k, d = 12, 8070
    x = (0.01 * RNG.normal(size=(k, d))).astype(np.float32)
    x[3] = 0.0
    for g in (RNG.normal(size=d).astype(np.float32),
              np.zeros(d, np.float32)):
        want = np.asarray(jpc.cosine_similarity(jnp.asarray(x),
                                                jnp.asarray(g),
                                                use_kernel=use_kernel))
        got = tpc.cosine_similarity(torch.from_numpy(x), torch.from_numpy(g),
                                    use_kernel=use_kernel)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)


def test_ops_dispatch_cpu_runs_the_twins():
    d = torch.from_numpy(RNG.normal(size=(4, 33)).astype(np.float32))
    g = torch.from_numpy(RNG.normal(size=33).astype(np.float32))
    dots, dn2, pn2, gn2 = ops.round_stats(d, g, d)
    stats, g2 = rs.round_stats_plain(d, g, d)
    torch.testing.assert_close(torch.stack([dots, dn2, pn2], 1), stats,
                               rtol=0, atol=0)
    assert ops.round_stats(d, g)[2] is None and float(gn2) == float(g2)
    p = torch.ones(4)
    agg, raw = ops.superpose_normalize(d, p, p, g)
    want, want_raw = aircomp_sum.superpose_normalize_plain(d, p, p, g)
    torch.testing.assert_close(agg, want, rtol=0, atol=0)
    assert float(raw) == float(want_raw) == 4.0
    torch.testing.assert_close(ops.aircomp_sum(d, p, g),
                               aircomp_sum.aircomp_sum_plain(d, p, g),
                               rtol=0, atol=0)
    parts = cs.cosine_partials_plain(d, g)
    gn = torch.sqrt((g * g).sum())
    torch.testing.assert_close(
        ops.cosine_sim(d, g), parts[:, 0] / (torch.sqrt(parts[:, 1]) * gn),
        rtol=0, atol=0)


def _good():
    d = torch.zeros((3, 5))
    return d, torch.zeros(5), torch.ones(3), torch.ones(3), torch.zeros(5)


@pytest.mark.parametrize("case", ["dtype", "g_dtype", "shape", "g_shape",
                                  "payload", "contiguous", "empty"])
def test_round_stats_wrappers_raise_on_bad_inputs(case):
    d, g, *_ = _good()
    p = None
    if case == "dtype":
        d = d.double()
    elif case == "g_dtype":
        g = g.to(torch.bfloat16)
    elif case == "shape":
        d = d.reshape(15)
    elif case == "g_shape":
        g = torch.zeros(4)
    elif case == "payload":
        p = torch.zeros((3, 4))
    elif case == "contiguous":
        d = torch.zeros((5, 3)).t()
    elif case == "empty":
        d, g = torch.zeros((0, 5)), torch.zeros(5)
    for fn in (ops.round_stats, rs.round_stats_plain, rs.round_stats_cuda):
        with pytest.raises((TypeError, ValueError)):
            fn(d, g, p)


@pytest.mark.parametrize("case", ["dtype", "powers_dtype", "mask_shape",
                                  "noise_shape", "contiguous"])
def test_superpose_wrappers_raise_on_bad_inputs(case):
    x, _, p, m, n = _good()
    if case == "dtype":
        x = x.half()
    elif case == "powers_dtype":
        p = p.double()
    elif case == "mask_shape":
        m = torch.ones(4)
    elif case == "noise_shape":
        n = torch.zeros(6)
    elif case == "contiguous":
        x = torch.zeros((5, 3)).t()
    for fn in (ops.superpose_normalize,
               aircomp_sum.superpose_normalize_plain,
               aircomp_sum.superpose_normalize_cuda):
        with pytest.raises((TypeError, ValueError)):
            fn(x, p, m, n)
    if case != "mask_shape":        # aircomp_sum takes no mask
        for fn in (ops.aircomp_sum, aircomp_sum.aircomp_sum_plain,
                   aircomp_sum.aircomp_sum_cuda):
            with pytest.raises((TypeError, ValueError)):
                fn(x, p, n)


@pytest.mark.parametrize("case", ["dtype", "g_dtype", "shape", "g_shape",
                                  "contiguous"])
def test_cosine_wrappers_raise_on_bad_inputs(case):
    d, g, *_ = _good()
    if case == "dtype":
        d = d.double()
    elif case == "g_dtype":
        g = g.to(torch.bfloat16)
    elif case == "shape":
        d = d.reshape(15)
    elif case == "g_shape":
        g = torch.zeros(4)
    elif case == "contiguous":
        d = torch.zeros((5, 3)).t()
    for fn in (ops.cosine_sim, cs.cosine_partials_plain,
               cs.cosine_partials_cuda):
        with pytest.raises((TypeError, ValueError)):
            fn(d, g)


def test_cuda_wrappers_refuse_cpu_tensors_without_launching():
    """The CUDA wrappers never run a CPU tensor (no build, no count)."""
    x, g, p, m, n = _good()

    def counts():
        return (rs.launches, aircomp_sum.launches,
                aircomp_sum.aircomp_sum_launches, cs.launches)
    before = counts()
    with pytest.raises(ValueError, match="CUDA"):
        rs.round_stats_cuda(x, g)
    with pytest.raises(ValueError, match="CUDA"):
        aircomp_sum.superpose_normalize_cuda(x, p, m, n)
    with pytest.raises(ValueError, match="CUDA"):
        aircomp_sum.aircomp_sum_cuda(x, p, n)
    with pytest.raises(ValueError, match="CUDA"):
        cs.cosine_partials_cuda(x, g)
    assert counts() == before


def test_ops_refuse_other_devices():
    x = torch.zeros((3, 5), device="meta")
    g = torch.zeros(5, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.round_stats(x, g)
    p = torch.ones(3, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.superpose_normalize(x, p, p, g)
    with pytest.raises(ValueError, match="device"):
        ops.aircomp_sum(x, p, g)
    with pytest.raises(ValueError, match="device"):
        ops.cosine_sim(x, g)
