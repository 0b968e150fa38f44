"""On-card tests of the port's CUDA kernels (marker ``cuda``; they skip on
a machine without a GPU). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.device import full_f32_matmul
    full_f32_matmul()
    return torch.device("cuda")


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=3e-5, atol=3e-4))


# The delta-plane sweeps' cases: every load width (D odd, even but not a
# multiple of 4, a multiple of 8; a pointer one element off 16-byte
# alignment); in sweep 1 blocks of 32 to 512 threads, one pass and several
# per row (D = 20000); in sweep 2 16 and 32 warps (K <= 256 and above), a
# warp's rows in one round of loads and in several (K = 1000), and a single
# ragged tile (D = 1, 511).
SWEEP_KS = (1, 16, 64, 100, 300, 1000)
SWEEP_DS = (1, 511, 8070, 8192, 20000)
SWEEP_CASES = ([(k, d, 0) for k in SWEEP_KS for d in SWEEP_DS]
               + [(3, 511, 0), (100, 8070, 1), (100, 8192, 1)])
# the MLP's leaves as the pytree carry sweeps them, in leaf order: l1.b,
# l1.w, l2.b, l2.w, l3.b, l3.w (widths 10, 7840, 100), aligned and one
# element off, at the paper's K and at K = 1000
MLP_LEAF_WIDTHS = (10, 7840, 10, 100, 10, 100)
SWEEP_CASES += sorted({(k, d, off) for k in (100, 1000)
                       for d in MLP_LEAF_WIDTHS for off in (0, 1)}
                      - set(SWEEP_CASES))
# the round-perf bench's hidden-64 MLP at its K = 16 and 1000: the raveled
# plane (d = 55,050) and the pytree carry's leaf widths
ROUND_PERF_WIDTHS = (55050, 50176, 4096, 640, 64, 10)
SWEEP_CASES += sorted({(k, d, 0) for k in (16, 1000)
                       for d in ROUND_PERF_WIDTHS} - set(SWEEP_CASES))


def _plane(gen, k, d, dtype, offset, device):
    """A contiguous (k, d) plane whose data pointer sits ``offset``
    elements past an allocation's start (offset 1 defeats wide loads)."""
    flat = torch.randn((k * d + offset,), generator=gen, device=device)
    return flat.to(dtype)[offset:].view(k, d)


@pytest.mark.parametrize("k,d,offset", SWEEP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_payload", [False, True])
def test_round_stats_kernel_matches_twin(cuda, k, d, offset, dtype,
                                         with_payload):
    from repro_torch.kernels import round_stats as rs
    gen = torch.Generator(device=cuda).manual_seed(k * d)
    x = _plane(gen, k, d, dtype, offset, cuda)
    g = torch.randn((d,), generator=gen, device=cuda)
    p = _plane(gen, k, d, dtype, offset, cuda) if with_payload else None
    if offset:
        assert rs.device_plan(x, g, p)[0] == 1
    before = rs.launches
    got, got_g = rs.round_stats_cuda(x, g, p)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    want, want_g = rs.round_stats_plain(x, g, p)
    torch.testing.assert_close(got, want, **_tol(dtype))
    torch.testing.assert_close(got_g, want_g, rtol=3e-5, atol=0.0)


def _mask(kind, gen, k, device):
    return {"zero": torch.zeros((k,), device=device),
            "full": torch.ones((k,), device=device),
            "partial": (torch.rand((k,), generator=gen, device=device)
                        < 0.5).float()}[kind]


@pytest.mark.parametrize("k,d,offset", SWEEP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["zero", "partial", "full"])
def test_superpose_kernel_matches_twin(cuda, k, d, offset, dtype,
                                       mask_kind):
    from repro_torch.kernels import aircomp_sum as ac
    gen = torch.Generator(device=cuda).manual_seed(k + d)
    x = _plane(gen, k, d, dtype, offset, cuda)
    p = 0.1 + 15.0 * torch.rand((k,), generator=gen, device=cuda)
    m = _mask(mask_kind, gen, k, cuda)
    n = 1e-3 * torch.randn((d,), generator=gen, device=cuda)
    if offset:
        assert ac.device_plan(x)[0] == 1
    before = ac.launches
    got, raw = ac.superpose_normalize_cuda(x, p, m, n)
    torch.cuda.synchronize()
    assert ac.launches == before + 1
    want, want_raw = ac.superpose_normalize_plain(x, p, m, n)
    tol = _tol(dtype) if dtype == torch.bfloat16 else dict(rtol=3e-5,
                                                           atol=3e-5)
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(raw, want_raw, rtol=3e-5, atol=0.0)
    if mask_kind == "zero":
        assert float(raw) == 0.0


@pytest.mark.parametrize("k,d,offset", SWEEP_CASES + [(4, 64, 0),
                                                      (37, 1111, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["zero", "partial", "full"])
def test_aircomp_sum_kernel_matches_twin(cuda, k, d, offset, dtype,
                                         mask_kind):
    from repro_torch.kernels import aircomp_sum as ac
    gen = torch.Generator(device=cuda).manual_seed(3 * k + d)
    x = _plane(gen, k, d, dtype, offset, cuda)
    m = _mask(mask_kind, gen, k, cuda)
    bp = (0.1 + 15.0 * torch.rand((k,), generator=gen, device=cuda)) * m
    n = 1e-3 * torch.randn((d,), generator=gen, device=cuda)
    before = ac.aircomp_sum_launches
    got = ac.aircomp_sum_cuda(x, bp, n)
    torch.cuda.synchronize()
    assert ac.aircomp_sum_launches == before + 1
    assert got.dtype == torch.float32
    want = ac.aircomp_sum_plain(x, bp, n)
    tol = (_tol(dtype) if dtype == torch.bfloat16
           else dict(rtol=3e-5, atol=3e-5))
    if mask_kind == "zero":            # noise / 1e-12
        tol = dict(rtol=3e-5, atol=0.0)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("k,d,offset", SWEEP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cosine_partials_kernel_matches_twin(cuda, k, d, offset, dtype):
    from repro_torch.kernels import cosine_sim as cs
    gen = torch.Generator(device=cuda).manual_seed(5 * k + d)
    x = _plane(gen, k, d, dtype, offset, cuda)
    g = torch.randn((d,), generator=gen, device=cuda)
    before = cs.launches
    got = cs.cosine_partials_cuda(x, g)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    torch.testing.assert_close(got, cs.cosine_partials_plain(x, g),
                               **_tol(dtype))


@pytest.mark.parametrize("k,d", [(1000, 8070), (100, 8070), (64, 8192),
                                 (1000, 511), (1, 20000), (16, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(cuda, k, d, dtype):
    """Bit-identical repeats at the paper's shapes and the edges: one and
    several passes per row, 16 and 32 warps a tile, float2, 16-byte and
    scalar loads."""
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import round_stats as rs
    gen = torch.Generator(device=cuda).manual_seed(k + 7 * d)
    x = torch.randn((k, d), generator=gen, device=cuda).to(dtype)
    g = torch.randn((d,), generator=gen, device=cuda)
    p = torch.rand((k,), generator=gen, device=cuda)
    m = torch.ones((k,), device=cuda)
    a = [torch.cat([s.reshape(-1) for s in rs.round_stats_cuda(x, g, x)])
         for _ in range(3)]
    b = [torch.cat([s.reshape(-1) for s in ac.superpose_normalize_cuda(
        x, p, m, g)]) for _ in range(3)]
    c = [ac.aircomp_sum_cuda(x, p, g) for _ in range(3)]
    e = [cs.cosine_partials_cuda(x, g) for _ in range(3)]
    for runs in (a, b, c, e):
        for r in runs[1:]:
            assert torch.equal(r, runs[0])


def _server(transmit="model"):
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.data.partition import partition_noniid
    from repro_torch.data.pipeline import build_federation
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.fl import FLClient, FusedPAOTA, PAOTAConfig
    from repro_torch.models.mlp import init_mlp_params, mlp_loss
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    parts = partition_noniid(y, n_clients=8, seed=0)
    clients = [FLClient(d, mlp_loss, 32, 0.1, 5)
               for d in build_federation(x, y, parts)]
    return FusedPAOTA(init_mlp_params(0), clients, ChannelConfig(),
                      SchedulerConfig(n_clients=8, seed=1),
                      PAOTAConfig(transmit=transmit))


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_fused_round_runs_through_both_kernels(cuda, transmit):
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    drv = _server(transmit)
    rs.launches = ac.launches = 0
    rows = drv.advance(10)
    assert (rs.launches, ac.launches) == (10, 10)
    assert np.isfinite(drv.global_vec).all()
    assert any(r["n_participants"] > 0 for r in rows)


def test_rounds_make_no_host_sync(cuda):
    """Between stages a round reads nothing back to the host: three rounds
    of scan_rounds run with torch's sync debug mode set to error."""
    from repro_torch.fl.runtime import scan_rounds
    drv = _server()
    drv.advance(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            scan_rounds(drv._carry, 3, rcfg=drv._rcfg, streams=drv._streams)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_host_server_launches_once_per_round_with_uploaders(cuda,
                                                            use_kernel):
    """The host-path PAOTAServer: round_stats launches once per round with
    uploaders, and the aggregation kernel (aircomp_sum with use_kernel,
    superpose_normalize without) once per such round; a zero-uploader round
    launches nothing."""
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.data.partition import partition_noniid
    from repro_torch.data.pipeline import build_federation
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.fl import FLClient, PAOTAConfig, PAOTAServer
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    from repro_torch.models.mlp import init_mlp_params, mlp_loss
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    parts = partition_noniid(y, n_clients=8, seed=0)
    clients = [FLClient(d, mlp_loss, 32, 0.1, 5)
               for d in build_federation(x, y, parts)]
    srv = PAOTAServer(init_mlp_params(0), clients, ChannelConfig(),
                      SchedulerConfig(n_clients=8, seed=1, lat_lo=20.0,
                                      lat_hi=30.0),
                      PAOTAConfig(use_kernel=use_kernel))
    rs.launches = ac.launches = ac.aircomp_sum_launches = 0
    rows = [srv.round() for _ in range(8)]
    busy = sum(r["n_participants"] > 0 for r in rows)
    assert 0 < busy < 8
    agg = (ac.aircomp_sum_launches, ac.launches)
    assert rs.launches == busy
    assert agg == ((busy, 0) if use_kernel else (0, busy))
    assert np.isfinite(srv.global_vec).all()


def _gs_case(dev, m, s, d, dtype, with_scale, dead=False):
    """(values, idx, bp, noise, scale) on the card: distinct indices in each
    row, dead rows with weight 0 holding garbage."""
    gen = torch.Generator(device=dev).manual_seed(m * 7919 + s * 31 + d)
    idx = torch.stack([torch.randperm(d, generator=gen, device=dev)[:s]
                       for _ in range(m)]).to(torch.int32)
    v = 1e-2 * torch.randn((m, s), generator=gen, device=dev)
    scale = None
    if dtype == torch.int8:
        v = torch.randint(-127, 128, (m, s), generator=gen,
                          device=dev).to(torch.int8)
    else:
        v = v.to(dtype)
    if with_scale:
        scale = 1e-4 + 1e-3 * torch.rand((m,), generator=gen, device=dev)
    bp = 0.1 + 15.0 * torch.rand((m,), generator=gen, device=dev)
    if dead:
        bp[1::3] = 0.0
    noise = 2.8e-7 * torch.randn((d,), generator=gen, device=dev)
    return v.contiguous(), idx, bp, noise, scale


@pytest.mark.parametrize("m,s,d", [(1, 1, 1), (3, 37, 1000), (5, 129, 257),
                                   (64, 504, 8070), (256, 1024, 16384)])
@pytest.mark.parametrize("dtype,with_scale", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
    (torch.int8, True)])
def test_gather_superpose_kernel_matches_twin(cuda, m, s, d, dtype,
                                              with_scale):
    """Each value type, ragged d (not a multiple of the 128-column stripe)
    and m*s not a multiple of the block's 256 threads, dead rows
    included: against the twin at the kernel tolerances, varsigma the raw
    sum of bp."""
    from repro_torch.kernels import gather_superpose as gs
    v, idx, bp, noise, scale = _gs_case(cuda, m, s, d, dtype, with_scale,
                                        dead=m > 2)
    before = gs.launches
    got, raw = gs.gather_superpose_cuda(v, idx, bp, noise, d=d, scale=scale)
    torch.cuda.synchronize()
    assert gs.launches == before + 1
    want, want_raw = gs.gather_superpose_plain(v, idx, bp, noise, d=d,
                                               scale=scale)
    tol = (_tol(dtype) if dtype == torch.bfloat16
           else dict(rtol=3e-5, atol=3e-5))
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(raw, want_raw, rtol=3e-5, atol=0.0)
    again, _ = gs.gather_superpose_cuda(v, idx, bp, noise, d=d, scale=scale)
    assert torch.equal(again, got)            # no atomics: bit-identical


def test_gather_superpose_all_dead_rows_give_noise_over_vs_min(cuda):
    from repro_torch.kernels import gather_superpose as gs
    v, idx, bp, noise, _ = _gs_case(cuda, 4, 50, 300, torch.float32, False)
    got, raw = gs.gather_superpose_cuda(v, idx, torch.zeros_like(bp), noise,
                                        d=300)
    torch.cuda.synchronize()
    assert float(raw) == 0.0
    torch.testing.assert_close(got, noise / 1e-12, rtol=3e-5, atol=0.0)


@pytest.mark.parametrize("kw", [
    dict(), dict(compress="randmask", compress_ratio=1 / 16),
    dict(compress="topk", compress_ratio=1 / 16),
    dict(compress="randmask", compress_ratio=1 / 16, slot_dtype="int8",
         error_feedback=False)],
    ids=["uncompressed", "randmask", "topk", "int8"])
def test_cohort_round_launches(cuda, kw):
    """The cohort round on the card: compressed, gather_superpose launches
    once per round and the dense sweeps never; uncompressed, the reverse."""
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.data.partition import partition_noniid
    from repro_torch.data.pipeline import build_federation
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.fl import FLClient, FusedPAOTA, PAOTAConfig
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import gather_superpose as gs
    from repro_torch.kernels import round_stats as rs
    from repro_torch.models.mlp import init_mlp_params, mlp_loss
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    parts = partition_noniid(y, n_clients=12, seed=0)
    clients = [FLClient(d, mlp_loss, 32, 0.1, 5)
               for d in build_federation(x, y, parts)]
    drv = FusedPAOTA(init_mlp_params(0), clients, ChannelConfig(),
                     SchedulerConfig(n_clients=12, seed=1),
                     PAOTAConfig(transmit="delta"), cohort_size=4, **kw)
    drv.advance(1)
    rs.launches = ac.launches = gs.launches = 0
    drv.advance(8)
    counts = (rs.launches, ac.launches, gs.launches)
    assert counts == ((0, 0, 8) if kw else (8, 8, 0))
    assert np.isfinite(drv.global_vec).all()


def _ssd_case(dev, g, q, n, p, dtype, seed):
    """The reference's sweep inputs (tests/test_kernels.py): cum a
    decreasing cumulative log-decay, B, C, xdt standard normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cum = -torch.cumsum(0.05 + 0.2 * torch.rand((g, q), generator=gen,
                                                device=dev), dim=1)
    b, c = (torch.randn((g, q, n), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    xdt = torch.randn((g, q, p), generator=gen, device=dev).to(dtype)
    return cum, b, c, xdt


@pytest.mark.parametrize("g,q,n,p", [(4, 32, 16, 32), (8, 64, 128, 64),
                                     (2, 256, 64, 64), (3, 128, 64, 32),
                                     (1024, 256, 128, 64), (3, 100, 40, 70),
                                     (2, 1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel_matches_twin(cuda, g, q, n, p, dtype):
    """The reference's four sweep shapes, the full-width layer shape and
    ragged ones (Q not a multiple of the 64-row tile, P over one tile, N
    not a multiple of the 32-column stage): against the twin at the
    reference's 2e-5 (f32) and 2e-2 (bf16), and bit-identical on repeat."""
    from repro_torch.kernels import ssd_chunk as sc
    cum, b, c, xdt = _ssd_case(cuda, g, q, n, p, dtype, g * q + n + p)
    before = sc.launches
    got = sc.ssd_intra_chunk_cuda(cum, b, c, xdt)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    want = sc.ssd_intra_chunk_plain(cum, b, c, xdt)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else dict(rtol=2e-5, atol=2e-5))
    assert got[0].dtype == dtype
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **tol)
    again = sc.ssd_intra_chunk_cuda(cum, b, c, xdt)
    for a, w in zip(got, again):
        assert torch.equal(a, w)


_SPLIT_CHECK = r"""
#include "tensor_core.cuh"

// Over every 32-bit word: count the non-NaN words whose hi from tc::split
// differs from cvt.rna.tf32.f32's word, and the NaN words whose lo is not
// NaN; keep the least word counted.
__global__ void check(unsigned long long* bad, unsigned* first) {
  unsigned long long n = 0;
  const unsigned long long step = 1ull * gridDim.x * blockDim.x;
  for (unsigned long long i = 1ull * blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const uint32_t w = static_cast<uint32_t>(i);
    const float x = __uint_as_float(w);
    uint32_t hi, lo, rna;
    tc::split(x, hi, lo);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(rna) : "f"(x));
    const bool nan = (w & 0x7fffffffu) > 0x7f800000u;
    if (nan ? !isnan(__uint_as_float(lo)) : hi != rna) {
      ++n;
      atomicMin(first, w);
    }
  }
  atomicAdd(bad, n);
}

extern "C" int split_check(unsigned long long* bad, unsigned* first) {
  check<<<1024, 256>>>(bad, first);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_tf32_split_is_cvt_rna_on_every_word(cuda, tmp_path):
    """tc::split (csrc/tensor_core.cuh), which the SSD and attention
    kernels run, rounds to TF32 on the bits: its hi word equals
    cvt.rna.tf32.f32's for every finite f32 word and both infinities, and a
    NaN gives a NaN lo. So ssd_chunk, which ran cvt.rna before the helper
    was shared, computes the same bits."""
    import ctypes
    import subprocess
    from repro_torch.kernels import build
    src = tmp_path / "split_check.cu"
    src.write_text(_SPLIT_CHECK)
    lib = tmp_path / "libsplit_check.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).split_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    first = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    assert fn(bad.data_ptr(), first.data_ptr()) == 0
    assert int(bad) == 0, f"first word off: {int(first) & 0xffffffff:#010x}"


def _swa_case(dev, bh, t, s, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=dev).to(dtype)
            for n in (t, s, s)]


# The tensor-core kernel's branches (T, S, D, W, causal): every instance's
# head dim (16 to 256; D = 33 and 40 have row pitches that are no 16-byte
# multiple in one or both dtypes and take plain loads), ragged T and S both
# ways, windows around the 64-key tile and beyond T, a query tile of edge
# tiles only (T = 64, no window), rows with no key (W = 0; T > S with a
# window), causal off with a window. chip_smoke.py holds the same list:
# change both.
SWA_BRANCHES = ((64, 64, 16, 1, True), (129, 200, 33, 63, True),
                (200, 129, 40, 64, True), (257, 257, 64, 65, True),
                (300, 280, 112, 1000, True), (190, 300, 128, 64, False),
                (64, 64, 128, None, True), (170, 100, 64, 20, True),
                (65, 70, 32, 0, True), (200, 180, 256, 63, True),
                (130, 130, 200, 65, False), (100, 100, 96, None, False))


@pytest.mark.parametrize("t,s,d,window,causal", [
    (128, 128, 64, None, True), (200, 200, 32, 64, True),
    (256, 256, 64, 96, True), (256, 256, 128, 128, True),
    (64, 64, 16, None, False), (96, 96, 64, 32, True),
    (130, 130, 64, 64, True),
    # beyond the reference's sweep: zamba2's head dim, ragged T != S,
    # a windowed encoder, the widest head, an empty band
    (300, 300, 112, 100, True), (100, 170, 48, 40, True),
    (150, 150, 40, 33, False), (70, 70, 256, None, True),
    (65, 65, 32, 0, True)] + list(SWA_BRANCHES))
def test_swa_attention_kernel_matches_twin(cuda, t, s, d, window, causal):
    from repro_torch.kernels import swa_attention as sw
    q, k, v = _swa_case(cuda, 3, t, s, d, torch.float32, t + s + d)
    before = sw.launches
    got = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    want = sw.swa_attention_plain(q, k, v, window=window, causal=causal)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    assert torch.equal(got, sw.swa_attention_cuda(q, k, v, window=window,
                                                  causal=causal))


@pytest.mark.parametrize("t,s,d,window,causal",
                         [(128, 128, 64, 64, True)] + list(SWA_BRANCHES))
def test_swa_attention_kernel_bf16(cuda, t, s, d, window, causal):
    from repro_torch.kernels import swa_attention as sw
    seed = 7 if (t, s, d) == (128, 128, 64) else 7 + t + d
    q, k, v = _swa_case(cuda, 2, t, s, d, torch.bfloat16, seed)
    got = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
    assert got.dtype == torch.bfloat16
    want = sw.swa_attention_plain(q, k, v, window=window, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    assert torch.equal(got, sw.swa_attention_cuda(q, k, v, window=window,
                                                  causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_kernel_unaligned_planes(cuda, dtype):
    """k and v one element past 16-byte alignment (a pitch that is a 16-byte
    multiple): the kernel stages them by plain loads, with the same result
    as aligned copies."""
    from repro_torch.kernels import swa_attention as sw
    q, k, v = _swa_case(cuda, 2, 150, 150, 128, dtype, 11)
    ks, vs = (torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:]
              .view(x.shape) for x in (k, v))
    ks.copy_(k)
    vs.copy_(v)
    assert ks.data_ptr() % 16 and ks.is_contiguous()
    got = sw.swa_attention_cuda(q, ks, vs, window=70)
    assert torch.equal(got, sw.swa_attention_cuda(q, k, v, window=70))


def test_swa_attention_gqa_route(cuda):
    """ops.swa_attention on the card: (B, T, H, D) / (B, S, Hkv, D) with the
    GQA repeat, against the same call on the CPU twin."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 96, 8, 32), generator=gen, device=cuda)
    k = torch.randn((2, 96, 2, 32), generator=gen, device=cuda)
    v = torch.randn((2, 96, 2, 32), generator=gen, device=cuda)
    before = sw.launches
    got = ops.swa_attention(q, k, v, window=48)
    assert sw.launches == before + 1
    want = ops.swa_attention(q.cpu(), k.cpu(), v.cpu(), window=48)
    torch.testing.assert_close(got.cpu(), want, rtol=3e-5, atol=3e-5)


def test_mamba2_prefill_runs_the_ssd_kernel_per_layer(cuda):
    """The reduced mamba2 on the card: the prefill step launches the ssd
    kernel once per layer, decode never, and prefill -> decode continues
    the full forward's logits (tests/test_serving.py's hand-off)."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step, forward, init_model
    cfg = get_reduced("mamba2-370m")
    model = init_model(cfg, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         device=cuda, dtype=torch.int32)
    with torch.inference_mode():
        full, _, _ = forward(model, {"tokens": toks})
        sc.launches = 0
        _, caches = prefill(model, {"tokens": toks[:, :11]})
        assert sc.launches == cfg.num_layers
        state = model.cache_from_prefill(caches, 2, 64, 11)
        outs = []
        for i in range(5):
            lg, state = decode_step(model, toks[:, 11 + i:12 + i], state,
                                    11 + i)
            outs.append(lg[:, 0])
    assert sc.launches == cfg.num_layers
    torch.testing.assert_close(torch.stack(outs, 1), full[:, 11:16],
                               rtol=3e-3, atol=3e-3)


def _grouped_case(dev, bz, nc, q, h, g, n, p, dtype, seed, offset=None):
    """Grouped SSD inputs: cum (Bz, NC, Q, H), xdt (Bz, NC, Q, H, P), and B,
    C (Bz, NC, Q, G, N), either contiguous or, with ``offset``, strided
    views of one conv-output-like (Bz, NC*Q, offset + 2 G N) tensor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cum = -torch.cumsum(0.05 + 0.2 * torch.rand((bz, nc, q, h), generator=gen,
                                                device=dev), dim=2)
    xdt = torch.randn((bz, nc, q, h, p), generator=gen, device=dev).to(dtype)
    if offset is None:
        b, c = (torch.randn((bz, nc, q, g, n), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
    else:
        xbc = torch.randn((bz, nc * q, offset + 2 * g * n), generator=gen,
                          device=dev).to(dtype)
        b = xbc[..., offset:offset + g * n].reshape(bz, nc, q, g, n)
        c = xbc[..., offset + g * n:].reshape(bz, nc, q, g, n)
        assert not b.is_contiguous()
    return cum, b, c, xdt


@pytest.mark.parametrize("bz,nc,q,h,g,n,p,offset", [
    (2, 2, 64, 4, 4, 32, 32, None),        # rep 1
    (2, 3, 128, 8, 2, 64, 64, None),       # rep 4
    (8, 4, 256, 32, 1, 128, 64, None),     # rep 32, mamba2-370m's layer
    (1, 2, 100, 8, 2, 40, 70, None),       # ragged Q, N, P
    (2, 2, 256, 32, 1, 128, 64, 2048),     # strided views, 16-byte rows
    (1, 2, 100, 8, 2, 40, 64, 3)],         # strided views, unaligned rows
    ids=["rep1", "rep4", "rep32", "ragged", "strided", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_grouped_kernel_matches_twin(cuda, bz, nc, q, h, g, n, p, offset,
                                         dtype):
    """The grouped kernel (one C B^T per group shared by its heads) against
    its twin at the reference's 2e-5 (f32) and 2e-2 (bf16), every output,
    one launch, and bit-identical on repeat."""
    from repro_torch.kernels import ssd_chunk as sc
    args = _grouped_case(cuda, bz, nc, q, h, g, n, p, dtype, q + h + n + p,
                         offset)
    before = sc.launches
    got = sc.ssd_intra_chunk_grouped_cuda(*args)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    want = sc.ssd_intra_chunk_grouped_plain(*args)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else dict(rtol=2e-5, atol=2e-5))
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert got[0].dtype == dtype
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **tol)
    again = sc.ssd_intra_chunk_grouped_cuda(*args)
    for a, w in zip(got, again):
        assert torch.equal(a, w)


@pytest.mark.parametrize("m,s,d", [(13, 40, 64), (40, 64, 65),
                                   (13, 100, 8449), (7, 3, 8448),
                                   (3, 1101, 5000), (50, 2048, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_gather_superpose_stripe_edges_and_ragged_rows(cuda, m, s, d, dtype):
    """Stripe edges (d at and one past a multiple of 64, past one 1024-wide
    stripe), row splits merged by the stripe's last block (m = 40, 50), m
    not a multiple of the 16 warps, rows longer than one staged segment,
    and s not a multiple of 4 (the 4-byte copies)."""
    from repro_torch.kernels import gather_superpose as gs
    v, idx, bp, noise, scale = _gs_case(cuda, m, s, d, dtype,
                                        dtype == torch.int8, dead=True)
    got, raw = gs.gather_superpose_cuda(v, idx, bp, noise, d=d, scale=scale)
    want, want_raw = gs.gather_superpose_plain(v, idx, bp, noise, d=d,
                                               scale=scale)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(raw, want_raw, rtol=3e-5, atol=0.0)
    again, _ = gs.gather_superpose_cuda(v, idx, bp, noise, d=d, scale=scale)
    assert torch.equal(again, got)


def test_gather_superpose_all_dead_rows_at_the_state_plane_shape(cuda):
    from repro_torch.kernels import gather_superpose as gs
    v, idx, bp, noise, _ = _gs_case(cuda, 256, 1024, 16384, torch.float32,
                                    False)
    got, raw = gs.gather_superpose_cuda(v, idx, torch.zeros_like(bp), noise,
                                        d=16384)
    torch.cuda.synchronize()
    assert float(raw) == 0.0
    torch.testing.assert_close(got, noise / 1e-12, rtol=3e-5, atol=0.0)


def _mlp_leaves(gen, k, dtype, device):
    """A stacked MLP tree as the pytree carry holds it: one contiguous
    tensor per leaf, each its own allocation."""
    shapes = {"l1": {"w": (784, 10), "b": (10,)},
              "l2": {"w": (10, 10), "b": (10,)},
              "l3": {"w": (10, 10), "b": (10,)}}
    return {layer: {name: torch.randn((k,) + shape, generator=gen,
                                      device=device).to(dtype)
                    for name, shape in leaves.items()}
            for layer, leaves in shapes.items()}


@pytest.mark.parametrize("k", [100, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pytree_sweeps_launch_once_per_leaf(cuda, k, dtype):
    """ops.round_stats and the pytree aggregate on a stacked MLP tree: six
    launches of each kernel, one per leaf (the 10-wide ones too), summed
    or split as the CPU twins on the same inputs do."""
    from repro_torch.core.aggregation import paota_aggregate_stacked, ravel
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import ops
    from repro_torch.kernels import round_stats as rs
    from repro_torch.tree import tree_map
    gen = torch.Generator(device=cuda).manual_seed(k)
    deltas = _mlp_leaves(gen, k, dtype, cuda)
    pay = _mlp_leaves(gen, k, dtype, cuda)
    g = tree_map(lambda t: t[0].float().contiguous(),
                 _mlp_leaves(gen, 1, torch.float32, cuda))
    p = 0.1 + 15.0 * torch.rand((k,), generator=gen, device=cuda)
    m = (torch.rand((k,), generator=gen, device=cuda) < 0.5).float()
    noise = 1e-3 * torch.randn((8070,), generator=gen, device=cuda)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
    before = rs.launches, ac.launches
    got = ops.round_stats(deltas, g, pay)
    agg, vs = paota_aggregate_stacked(pay, p, m, noise)
    torch.cuda.synchronize()
    assert (rs.launches, ac.launches) == (before[0] + 6, before[1] + 6)
    want = ops.round_stats(cpu(deltas), cpu(g), cpu(pay))
    for x, w in zip(got, want):
        torch.testing.assert_close(x.cpu(), w, **_tol(dtype))
    w_agg, w_vs = paota_aggregate_stacked(cpu(pay), p.cpu(), m.cpu(),
                                          noise.cpu())
    tol = _tol(dtype) if dtype == torch.bfloat16 else dict(rtol=3e-5,
                                                           atol=3e-5)
    torch.testing.assert_close(ravel(agg)[0].cpu(), ravel(w_agg)[0], **tol)
    torch.testing.assert_close(vs.cpu(), w_vs, rtol=3e-5, atol=0.0)


@pytest.mark.parametrize("d", [10, 7840, 8070])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_payload", [False, True])
def test_round_stats_nonfinite_rows_stay_in_their_rows(cuda, d, dtype,
                                                       with_payload):
    """A NaN row and an Inf row (what fault injection uploads) give
    non-finite stats in those rows only, which the screen reads; every
    other row matches the twin."""
    from repro_torch.kernels import round_stats as rs
    gen = torch.Generator(device=cuda).manual_seed(d)
    k = 100
    x = torch.randn((k, d), generator=gen, device=cuda).to(dtype)
    x[3, d // 2] = float("nan")
    x[7] = float("inf")
    p = x.clone() if with_payload else None
    g = torch.randn((d,), generator=gen, device=cuda)
    got, gn2 = rs.round_stats_cuda(x, g, p)
    want, want_g = rs.round_stats_plain(x, g, p)
    torch.cuda.synchronize()
    bad = torch.zeros((k,), dtype=torch.bool, device=cuda)
    bad[[3, 7]] = True
    assert not torch.isfinite(got[bad]).any(dim=1).any()
    assert torch.isfinite(got[~bad]).all()
    torch.testing.assert_close(got[~bad], want[~bad], **_tol(dtype))
    assert torch.isfinite(gn2)
    torch.testing.assert_close(gn2, want_g, rtol=3e-5, atol=0.0)


@pytest.mark.parametrize("k,d", [(100, 8070), (1000, 8070), (100, 10),
                                 (100, 7840)])
def test_bf16_sweeps_repeat_bit_identical(cuda, k, d):
    """Both sweeps on a bf16 plane return the same bits on every call (a
    fixed reduction order, no atomics)."""
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    gen = torch.Generator(device=cuda).manual_seed(k + d)
    x = torch.randn((k, d), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((d,), generator=gen, device=cuda)
    p = 0.1 + 15.0 * torch.rand((k,), generator=gen, device=cuda)
    m = (torch.rand((k,), generator=gen, device=cuda) < 0.5).float()
    n = 1e-3 * torch.randn((d,), generator=gen, device=cuda)
    first = (rs.round_stats_cuda(x, g, x), ac.superpose_normalize_cuda(
        x, p, m, n))
    for _ in range(3):
        again = (rs.round_stats_cuda(x, g, x),
                 ac.superpose_normalize_cuda(x, p, m, n))
        for a, b in zip(first, again):
            for u, v in zip(a, b):
                assert torch.equal(u, v)


KERNEL_BENCH_ROWS = ("aircomp_sum", "cosine_partials", "round_stats",
                     "superpose_normalize", "swa")


@pytest.mark.parametrize("row", KERNEL_BENCH_ROWS)
def test_kernels_bench_rows_time_kernel_and_twin_on_the_same_inputs(
        cuda, row):
    """Each kernels-bench pair holds the same inputs: the kernel row's call
    agrees with the ``_ref_`` row's twin, and launches the kernel once."""
    from repro_torch.bench import kernels_bench as kb
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import swa_attention as sw
    counter = {"aircomp_sum": (ac, "aircomp_sum_launches"),
               "cosine_partials": (cs, "launches"),
               "round_stats": (rs, "launches"),
               "superpose_normalize": (ac, "launches"),
               "swa": (sw, "launches")}[row]
    (case,) = [c for c in kb.cases(cuda) if c[1].startswith(row + "_")]
    ref_name, name, twin, kernel, args, _ = case
    assert ref_name == name.replace(row, row + "_ref", 1)
    assert all(a.device.type == "cuda" for a in args)
    before = getattr(*counter)
    got = kernel(*args)
    assert getattr(*counter) == before + 1
    want = twin(*args)
    for a, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(a, w, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_paper_harness_launches_each_sweep_once_per_paota_round(
        cuda, engine, monkeypatch):
    """The harness's servers at K = 8 for 6 rounds: PAOTA launches each
    sweep once per round on the fused round, and once per aggregating
    round on the host path (a period nobody finished in skips both); the
    baselines launch neither."""
    from repro_torch.bench import common
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    monkeypatch.delenv("REPRO_BENCH_FULL", raising=False)
    s = common.BenchSetting(n_clients=8, n_rounds=6, n_select=4,
                            engine=engine)
    clients, params, data = common.build_world(s)
    for name in ("paota", "local_sgd", "cotaf"):
        monkeypatch.setattr(rs, "launches", 0)
        monkeypatch.setattr(ac, "launches", 0)
        srv = common.make_server(name, s, clients, params, device=cuda)
        rows = [srv.round() for _ in range(s.n_rounds)]
        want = 0
        if name == "paota":
            want = (s.n_rounds if engine == "fused" else
                    sum(r["n_participants"] > 0 for r in rows))
            assert want > 0
        assert (rs.launches, ac.launches) == (want, want), name
