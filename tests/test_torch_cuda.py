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
# window), causal off with a window, hubert-xlarge's encoder row (D = 80
# padded to 96, causal off, no window, a ragged T = 1,500).
# chip_smoke.py holds the same list: change both.
SWA_BRANCHES = ((64, 64, 16, 1, True), (129, 200, 33, 63, True),
                (200, 129, 40, 64, True), (257, 257, 64, 65, True),
                (300, 280, 112, 1000, True), (190, 300, 128, 64, False),
                (64, 64, 128, None, True), (170, 100, 64, 20, True),
                (65, 70, 32, 0, True), (200, 180, 256, 63, True),
                (130, 130, 200, 65, False), (100, 100, 96, None, False),
                (1500, 1500, 80, None, False))


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


@pytest.mark.parametrize("t,d,h,hkv", [(300, 64, 9, 3), (2112, 64, 9, 3),
                                       (2112, 128, 32, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_full_causal_band_gqa(cuda, t, d, h, hkv, dtype):
    """The dense family's attention: no window, the whole causal triangle,
    through ops.swa_attention with GQA groups of 3 (smollm's 9 heads over
    3, D = 64) and 4 (granite's 32 over 8, D = 128), T = 300 (three query
    tiles, the last ragged) and 2,112: one launch, against the twin on the
    same repeated inputs, and bit-equal on a rerun."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    gen = torch.Generator(device=cuda).manual_seed(t + d + h)
    q = torch.randn((2, t, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, t, hkv, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    before = sw.launches
    got = ops.swa_attention(q, k, v, window=None)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    want = sw.swa_attention_plain(*ops.swa_layout(q, k, v))
    want = want.reshape(2, h, t, d).transpose(1, 2)
    tol = (dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16
           else dict(rtol=3e-5, atol=3e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, ops.swa_attention(q, k, v, window=None))


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


def _reduced_zamba2():
    """Reduced zamba2 with 5 layers (3 shared-attention slots), made on
    the CPU from seed 0, and the same params on the card."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_model
    cfg = dataclasses.replace(get_reduced("zamba2-7b"), num_layers=5)
    cpu = init_model(cfg, seed=0, device="cpu")
    card = init_model(cfg, seed=0, device="cpu").to("cuda")
    return cfg, cpu, card


@pytest.mark.parametrize("t_pre", [11, 100, 300])
def test_zamba2_reduced_on_card_matches_cpu_route(cuda, t_pre):
    """The reduced hybrid model on the card (kernels) against the same
    model on the CPU (twins) at the reference's LM tolerance: the forward's
    logits and caches, the hand-off (100 and 300 wrap the 64-slot ring; 300
    spans three query tiles of the attention kernel) and 5 teacher-forced
    decode steps. The prefill launches swa_attention once per shared slot
    and ssd_chunk once per layer; decode launches neither."""
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step, forward
    tol = dict(rtol=1e-4, atol=1e-5)
    cfg, cpu, card = _reduced_zamba2()
    toks = torch.from_numpy(np.random.default_rng(t_pre).integers(
        0, cfg.vocab_size, (2, t_pre + 5)).astype(np.int32))
    got, want = {}, {}
    for name, model, dev in (("card", card, cuda), ("cpu", cpu, "cpu")):
        out = got if name == "card" else want
        tk = toks.to(dev)
        with torch.inference_mode():
            sc.launches = sw.launches = 0
            logits, _, caches = forward(model, {"tokens": tk[:, :t_pre]},
                                        return_cache=True)
            if name == "card":
                assert (sw.launches, sc.launches) == (3, cfg.num_layers)
                sc.launches = sw.launches = 0
                prefill(model, {"tokens": tk[:, :t_pre]})
                assert (sw.launches, sc.launches) == (3, cfg.num_layers)
                sc.launches = sw.launches = 0
        out["logits"] = logits
        out.update({f"kv_{k}": v for k, v in caches["shared_kv"].items()})
        out.update(caches["ssm_states"])
        state = model.cache_from_prefill(caches, 2, 128, t_pre)
        for i in range(5):
            lg, state = decode_step(model, tk[:, t_pre + i:t_pre + i + 1],
                                    state, t_pre + i)
            out[f"decode_{i}"] = lg
        out.update({f"ring_{k}": v for k, v in state["shared_kv"].items()})
        if name == "card":
            assert (sw.launches, sc.launches) == (0, 0)
    for key, w in want.items():
        torch.testing.assert_close(got[key].cpu(), w, **tol, msg=key)


def test_zamba2_serve_generates_on_card(cuda):
    """The serve CLI's generate on the card: the first token after a
    100-token prompt is the prefill's argmax, the rest continue it."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward
    cfg, _, card = _reduced_zamba2()
    gen = torch.Generator(device=cuda).manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen,
                           device=cuda, dtype=torch.int32)
    out, t_pre, _, _ = generate(card, prompt, steps=3, cache=128)
    assert tuple(out.shape) == (2, 4) and t_pre is not None
    with torch.inference_mode():
        full, _, _ = forward(card, {"tokens": torch.cat([prompt, out[:, :3]],
                                                        1)})
    torch.testing.assert_close(out, full[:, 99:].argmax(-1).to(out.dtype))


@pytest.mark.parametrize("t_pre", [11, 300])
def test_dense_reduced_on_card_matches_cpu_route(cuda, t_pre):
    """Reduced granite-3-8b (untied unembedding, logit scale 1/16, a GQA
    group of 4) on the card (the attention kernel) against the same model
    on the CPU (the twin) at the reference's LM tolerance: the prefill
    step's logits, the forward's logits and per-layer caches (T = 300
    spans three query tiles), the hand-off and 5 teacher-forced decode
    steps. A prefill launches swa_attention once per layer; decode never."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step, forward, init_model
    tol = dict(rtol=1e-4, atol=1e-5)
    cfg = get_reduced("granite-3-8b")
    cpu = init_model(cfg, seed=0, device="cpu")
    card = init_model(cfg, seed=0, device="cpu").to(cuda)
    toks = torch.from_numpy(np.random.default_rng(t_pre).integers(
        0, cfg.vocab_size, (2, t_pre + 5)).astype(np.int32))
    got, want = {}, {}
    for name, model, dev in (("card", card, cuda), ("cpu", cpu, "cpu")):
        out = got if name == "card" else want
        tk = toks.to(dev)
        sw.launches = 0
        out["prefill"], _ = prefill(model, {"tokens": tk[:, :t_pre]})
        with torch.inference_mode():
            logits, _, caches = forward(model, {"tokens": tk[:, :t_pre]},
                                        return_cache=True)
        if name == "card":
            assert sw.launches == 2 * cfg.num_layers
        out["logits"] = logits
        out.update({f"kv_{k}": v for k, v in caches.items()})
        state = model.cache_from_prefill(caches, 2, 320, t_pre)
        for i in range(5):
            lg, state = decode_step(model, tk[:, t_pre + i:t_pre + i + 1],
                                    state, t_pre + i)
            out[f"decode_{i}"] = lg
        out.update({f"ring_{k}": v for k, v in state.items()})
        if name == "card":
            assert sw.launches == 2 * cfg.num_layers
    for key, w in want.items():
        torch.testing.assert_close(got[key].cpu(), w, **tol, msg=key)


@pytest.mark.parametrize("t_pre", [11, 150])
def test_moe_reduced_on_card_matches_cpu_route(cuda, t_pre):
    """Reduced mixtral-8x22b (4 experts top-2 at the published capacity
    1.25, a 64-token window, 6 query heads over 1 kv head: a GQA group of
    6, as the full model's 48 over 8) on the card against the same model
    on the CPU at the reference's LM tolerance: the prefill step's logits,
    the forward's logits, aux and per-layer caches (T = 150 is past the
    window), the hand-off into a wrapping 64-slot ring and 5 teacher-
    forced decode steps (two tokens a step: one slot per expert). A
    prefill launches swa_attention once per layer; decode never."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step, forward, init_model
    tol = dict(rtol=1e-4, atol=1e-5)
    cfg = dataclasses.replace(get_reduced("mixtral-8x22b"), num_heads=6,
                              num_kv_heads=1)
    cpu = init_model(cfg, seed=0, device="cpu")
    card = init_model(cfg, seed=0, device="cpu").to(cuda)
    toks = torch.from_numpy(np.random.default_rng(t_pre).integers(
        0, cfg.vocab_size, (2, t_pre + 5)).astype(np.int32))
    got, want = {}, {}
    for name, model, dev in (("card", card, cuda), ("cpu", cpu, "cpu")):
        out = got if name == "card" else want
        tk = toks.to(dev)
        sw.launches = 0
        out["prefill"], _ = prefill(model, {"tokens": tk[:, :t_pre]})
        with torch.inference_mode():
            logits, aux, caches = forward(model, {"tokens": tk[:, :t_pre]},
                                          return_cache=True)
        if name == "card":
            assert sw.launches == 2 * cfg.num_layers
        out["logits"], out["aux"] = logits, aux
        out.update({f"kv_{k}": v for k, v in caches.items()})
        state = model.cache_from_prefill(caches, 2, 160, t_pre)
        for i in range(5):
            lg, state = decode_step(model, tk[:, t_pre + i:t_pre + i + 1],
                                    state, t_pre + i)
            out[f"decode_{i}"] = lg
        out.update({f"ring_{k}": v for k, v in state.items()})
        if name == "card":
            assert sw.launches == 2 * cfg.num_layers
    assert got["ring_k"].shape[2] == 64
    for key, w in want.items():
        torch.testing.assert_close(got[key].cpu(), w, **tol, msg=key)


@pytest.mark.parametrize("t_text", [3, 292])
def test_vlm_reduced_on_card_matches_cpu_route(cuda, t_text):
    """Reduced internvl2-1b with 14 query heads over 2 (the full model's
    GQA group of 7) on the card (the attention kernel) against the same
    model on the CPU (the twin) at the reference's LM tolerance, over
    [8 patches; T tokens] (P + T = 11, and 300: three query tiles, the
    last ragged): the prefill step's logits, the forward's logits and
    per-layer caches, the hand-off and 5 teacher-forced decode steps from
    index P + T. A prefill launches swa_attention once per layer; decode
    never."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step, forward, init_model
    tol = dict(rtol=1e-4, atol=1e-5)
    cfg = dataclasses.replace(get_reduced("internvl2-1b"), num_heads=14,
                              num_kv_heads=2)
    cpu = init_model(cfg, seed=0, device="cpu")
    card = init_model(cfg, seed=0, device="cpu").to(cuda)
    rng = np.random.default_rng(t_text)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, t_text + 5)).astype(np.int32))
    patches = torch.from_numpy(rng.normal(size=(
        2, cfg.num_patches, cfg.frontend_dim)).astype(np.float32))
    n = cfg.num_patches + t_text
    got, want = {}, {}
    for name, model, dev in (("card", card, cuda), ("cpu", cpu, "cpu")):
        out = got if name == "card" else want
        tk = toks.to(dev)
        batch = {"tokens": tk[:, :t_text], "patch_embeds": patches.to(dev)}
        sw.launches = 0
        out["prefill"], _ = prefill(model, batch)
        with torch.inference_mode():
            logits, _, caches = forward(model, batch, return_cache=True)
        if name == "card":
            assert sw.launches == 2 * cfg.num_layers
        out["logits"] = logits
        out.update({f"kv_{k}": v for k, v in caches.items()})
        state = model.cache_from_prefill(caches, 2, 320, n)
        for i in range(5):
            lg, state = decode_step(model, tk[:, t_text + i:t_text + i + 1],
                                    state, n + i)
            out[f"decode_{i}"] = lg
        out.update({f"ring_{k}": v for k, v in state.items()})
        if name == "card":
            assert sw.launches == 2 * cfg.num_layers
    assert got["kv_k"].shape[2] == n
    for key, w in want.items():
        torch.testing.assert_close(got[key].cpu(), w, **tol, msg=key)


@pytest.mark.parametrize("t", [40, 1500])
def test_audio_reduced_on_card_matches_cpu_route(cuda, t):
    """Reduced hubert-xlarge with the full model's head dim of 80 (the
    kernel's D = 96 instance) on the card against the same model on the
    CPU at the reference's LM tolerance, frames masked at the published
    0.08: the forward's logits and caches and the prefill step's last
    logits (no caches) at T = 40 and 1,500. Each pass launches the
    bidirectional swa_attention once per layer."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch.steps import prefill
    from repro_torch.models import forward, init_model
    tol = dict(rtol=1e-4, atol=1e-5)
    cfg = dataclasses.replace(get_reduced("hubert-xlarge"), head_dim=80)
    cpu = init_model(cfg, seed=0, device="cpu")
    card = init_model(cfg, seed=0, device="cpu").to(cuda)
    rng = np.random.default_rng(t)
    batch = {"frame_feats": torch.from_numpy(rng.normal(
                 size=(2, t, cfg.frontend_dim)).astype(np.float32)),
             "mask_indicator": torch.from_numpy(
                 (rng.random((2, t)) < cfg.mask_prob).astype(np.int32))}
    got, want = {}, {}
    for name, model, dev in (("card", card, cuda), ("cpu", cpu, "cpu")):
        out = got if name == "card" else want
        b = {k: v.to(dev) for k, v in batch.items()}
        sw.launches = 0
        with torch.inference_mode():
            logits, _, caches = forward(model, b, return_cache=True)
        out["logits"] = logits
        out.update({f"kv_{k}": v for k, v in caches.items()})
        out["prefill"], none = prefill(model, b)
        assert none is None
        if name == "card":
            assert sw.launches == 2 * cfg.num_layers
    for key, w in want.items():
        torch.testing.assert_close(got[key].cpu(), w, **tol, msg=key)


@pytest.mark.parametrize("t", [300, 4160])
@pytest.mark.parametrize("scale", [1.0, 1.5684])
def test_swa_attention_window_gqa6(cuda, t, scale):
    """mixtral-8x22b's attention layout through ops.swa_attention: 48 query
    heads over 8 kv heads (a GQA group of 6), D = 128, a 4,096-token
    window, T = 300 (inside the window) and 4,160 (past it), inputs of std
    1 and 1.5684 (0.02 sqrt(6144): q, k, v of mixtral's first layer, whose
    softmax is peaked; an O accumulated in the mma over the whole band
    drifted 1e-4 there): one launch, against the twin on the same repeated
    inputs, bit-equal on a rerun."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    gen = torch.Generator(device=cuda).manual_seed(t)
    q = scale * torch.randn((1, t, 48, 128), generator=gen, device=cuda)
    k, v = (scale * torch.randn((1, t, 8, 128), generator=gen, device=cuda)
            for _ in range(2))
    before = sw.launches
    got = ops.swa_attention(q, k, v, window=4096)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    want = sw.swa_attention_plain(*ops.swa_layout(q, k, v), window=4096)
    want = want.reshape(1, 48, t, 128).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    assert torch.equal(got, ops.swa_attention(q, k, v, window=4096))


def _grouped_case(dev, bz, nc, q, h, g, n, p, dtype, seed, offset=None):
    """Grouped SSD inputs (``ssd_chunk.grouped_example``): cum (Bz, NC, Q,
    H), xdt (Bz, NC, Q, H, P), and B, C (Bz, NC, Q, G, N), either
    contiguous or, with ``offset``, strided views of one conv-output-like
    (Bz, NC*Q, offset + 2 G N) tensor."""
    from repro_torch.kernels import ssd_chunk as sc
    cum, b, c, xdt = sc.grouped_example(bz, nc, q, h, g, n, p, dtype=dtype,
                                        seed=seed, offset=offset, device=dev)
    assert offset is None or not b.is_contiguous()
    return cum, b, c, xdt


@pytest.mark.parametrize("bz,nc,q,h,g,n,p,offset", [
    (2, 2, 64, 4, 4, 32, 32, None),        # rep 1
    (2, 3, 128, 8, 2, 64, 64, None),       # rep 4
    (8, 4, 256, 32, 1, 128, 64, None),     # rep 32, mamba2-370m's layer
    (2, 4, 256, 112, 1, 64, 64, 7168),     # zamba2-7b's layer, its views
    (1, 2, 100, 8, 2, 40, 70, None),       # ragged Q, N, P
    (2, 2, 256, 32, 1, 128, 64, 2048),     # strided views, 16-byte rows
    (1, 2, 100, 8, 2, 40, 64, 3)],         # strided views, unaligned rows
    ids=["rep1", "rep4", "rep32", "zamba2", "ragged", "strided",
         "unaligned"])
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


# The sharded compressed round's partial entry (gather_superpose.cu
# repro_gather_superpose_partial): a rank's slots of the cohort at K =
# 1000, m = 64 over 4 ranks and of the state plane's m = 256, stripe edges
# with row splits merged by a stripe's last block, the one-element case,
# and an offset into the flat buffer.
GS_PARTIAL_CASES = [(16, 504, 8070, 0), (64, 1024, 16384, 0),
                    (40, 64, 65, 3), (50, 2048, 20000, 1), (1, 1, 1, 0),
                    (3, 37, 1000, 5)]


@pytest.mark.parametrize("m,s,d,offset", GS_PARTIAL_CASES)
@pytest.mark.parametrize("dtype,with_scale", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
    (torch.int8, True)])
def test_gather_superpose_partial_kernel_matches_twin(cuda, m, s, d, offset,
                                                      dtype, with_scale):
    """The partial entry against its twin (a dense scatter_add, w @ dense,
    Σ bp appended): the sums held divided by Σ bp, as the finished
    aggregate is, at 3e-5 (f32, int8: exact values) and 2e-2 (bf16); the
    raw Σ bp in the last slot; bit-identical on repeat; the rest of the
    buffer untouched."""
    from repro_torch.kernels import gather_superpose as gs
    v, idx, bp, _, scale = _gs_case(cuda, m, s, d, dtype, with_scale,
                                    dead=m > 2)
    n = offset + d + 3
    fill = torch.full((n,), -7.0, device=cuda)
    got, again, want = fill.clone(), fill.clone(), fill.clone()
    before = gs.partial_launches
    gs.gather_superpose_partial_cuda(v, idx, bp, got, offset, d=d,
                                     scale=scale)
    gs.gather_superpose_partial_cuda(v, idx, bp, again, offset, d=d,
                                     scale=scale)
    torch.cuda.synchronize()
    assert gs.partial_launches == before + 2
    gs.gather_superpose_partial_plain(v, idx, bp, want, offset, d=d,
                                      scale=scale)
    tol = (_tol(dtype) if dtype == torch.bfloat16
           else dict(rtol=3e-5, atol=3e-5))
    vs = torch.clamp_min(want[-1], 1e-12)
    cols = slice(offset, offset + d)
    torch.testing.assert_close(got[cols] / vs, want[cols] / vs, **tol)
    torch.testing.assert_close(got[-1], want[-1], rtol=3e-5, atol=0.0)
    assert torch.equal(got, again)
    rest = torch.ones((n,), dtype=torch.bool, device=cuda)
    rest[cols] = False
    rest[-1] = False
    assert torch.equal(got[rest], fill[rest])


def test_gather_superpose_partial_all_dead_rows_give_zeros(cuda):
    from repro_torch.kernels import gather_superpose as gs
    v, idx, bp, _, _ = _gs_case(cuda, 64, 1024, 16384, torch.float32, False)
    out = torch.full((16385,), -7.0, device=cuda)
    gs.gather_superpose_partial_cuda(v, idx, torch.zeros_like(bp), out,
                                     d=16384)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_compressed_aggregate_through_a_reducer_launches_the_partial(cuda):
    """``paota_aggregate_compressed(reducer=)`` on a one-rank mesh (the
    all-reduce is the identity): one partial launch, none of the fused
    kernel, and the fused route's aggregate and varsigma at 3e-5."""
    from repro_torch.core.aggregation import paota_aggregate_compressed
    from repro_torch.kernels import gather_superpose as gs
    from repro_torch.launch.collectives import Reducer
    from repro_torch.launch.mesh import Mesh
    v, idx, bp, noise, scale = _gs_case(cuda, 16, 504, 8070, torch.int8,
                                        True, dead=True)
    mask = (bp > 0).float()
    want, want_vs = paota_aggregate_compressed(v, idx, bp, mask, noise,
                                               8070, scale=scale)
    fused, part = gs.launches, gs.partial_launches
    got, got_vs = paota_aggregate_compressed(
        v, idx, bp, mask, noise, 8070, scale=scale,
        reducer=Reducer(Mesh((("data", 1),))))
    torch.cuda.synchronize()
    assert (gs.launches - fused, gs.partial_launches - part) == (0, 1)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(got_vs, want_vs, rtol=3e-5, atol=0.0)


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


# The backward's cases (T, S, D, W, causal): every head dim of its
# instances (32 to 128, 48 and 80 padded), ragged T and S both ways,
# windows around the 64-row tile and beyond T, causal off with and without
# a window (hubert-xlarge's D = 80 encoder row at T = 1,500), rows with no
# key (W = 0; T > S with a window: zero gradients); T and S ragged at
# both the 32-query tiles (the dK / dV pass's at D > 80) and the 64-row
# plan tiles (1,000 and 968).
SWA_BWD_CASES = ((128, 128, 64, None, True), (200, 200, 32, 64, True),
                 (257, 257, 64, 65, True), (300, 280, 112, 1000, True),
                 (190, 300, 128, 64, False), (100, 170, 48, 40, True),
                 (150, 150, 80, 33, False), (1500, 1500, 80, None, False),
                 (65, 70, 32, 0, True), (170, 100, 64, 20, True),
                 (1000, 1000, 128, 300, True), (1000, 968, 112, None, False))


def _swa_bwd_case(dev, t, s, d, window, causal, dtype, seed):
    from repro_torch.kernels import swa_attention as sw
    q, k, v = _swa_case(dev, 3, t, s, d, dtype, seed)
    out, lse = sw.swa_attention_cuda(q, k, v, window=window, causal=causal,
                                     return_lse=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
    return q, k, v, out, dout, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,d,window,causal", SWA_BWD_CASES)
def test_swa_attention_bwd_kernel_matches_twin(cuda, t, s, d, window, causal,
                                               dtype):
    """The backward kernel against swa_attention_bwd_plain on the same q,
    k, v, out, dout and log-sum-exp (3e-5 in f32; in bf16 rtol 1e-2, atol
    1e-3: both round f32 sums to bf16, one bf16 step apart at most, 2^-7
    of the value), one count
    a call, bit-identical on a rerun; the forward's log-sum-exp against the
    twin's, and its output with the log-sum-exp bit-equal to the serving
    call's (null pointer)."""
    from repro_torch.kernels import swa_attention as sw
    q, k, v, out, dout, lse = _swa_bwd_case(cuda, t, s, d, window, causal,
                                            dtype, t + s + d)
    assert torch.equal(out, sw.swa_attention_cuda(q, k, v, window=window,
                                                  causal=causal))
    _, want_lse = sw.swa_attention_plain(q, k, v, window=window,
                                         causal=causal, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=3e-5, atol=3e-5)
    before = sw.bwd_launches
    got = sw.swa_attention_bwd_cuda(q, k, v, out, dout, lse, window=window,
                                    causal=causal)
    torch.cuda.synchronize()
    assert sw.bwd_launches == before + 1
    want = sw.swa_attention_bwd_plain(q, k, v, out, dout, lse,
                                      window=window, causal=causal)
    tol = (dict(rtol=1e-2, atol=1e-3) if dtype == torch.bfloat16
           else dict(rtol=3e-5, atol=3e-5))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=name)
    again = sw.swa_attention_bwd_cuda(q, k, v, out, dout, lse, window=window,
                                      causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    rows = sw.band_mask(t, s, window, causal, cuda).any(-1)
    assert not got[0][:, ~rows].any()


def test_swa_attention_bwd_long_peaked_band_f64(cuda):
    """A long peaked band: 2 rows, T = S = 8,192, W = 4,096, D = 128, q,
    k, v of std 1.5684 (mixtral's first layer, as
    test_swa_attention_window_gqa6), f32. The kernel, handed the f64
    oracle's output and log-sum-exp rounded to f32, against torch's f64
    autograd through the plain softmax attention on the same values, within
    the twin's 3e-5: a dK or dV accumulated in the mma over the band's
    128 query tiles (dQ over its 64 key tiles) would drift past it."""
    from repro_torch.kernels import swa_attention as sw
    t, w, d, scale = 8192, 4096, 128, 1.5684
    gen = torch.Generator(device=cuda).manual_seed(t + w)
    q, k, v = (scale * torch.randn((2, t, d), generator=gen, device=cuda)
               for _ in range(3))
    dout = torch.randn((2, t, d), generator=gen, device=cuda)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    logits = leaves[0] @ leaves[1].transpose(1, 2) / d ** 0.5
    logits = logits.masked_fill(~sw.band_mask(t, t, w, True, cuda),
                                float("-inf"))
    lse = torch.logsumexp(logits, -1)
    out = torch.softmax(logits, -1) @ leaves[2]
    out.backward(dout.double())
    del logits
    got = sw.swa_attention_bwd_cuda(q, k, v, out.detach().float(), dout,
                                    lse.detach().float(), window=w)
    torch.cuda.synchronize()
    for name, g, x in zip(("dq", "dk", "dv"), got, leaves):
        torch.testing.assert_close(g.double(), x.grad, rtol=3e-5, atol=3e-5,
                                   msg=name)


@pytest.mark.parametrize("h,hkv,d,window,causal", [
    (9, 3, 64, None, True), (14, 2, 64, None, True), (6, 1, 128, 48, True),
    (4, 4, 80, None, False)])
def test_swa_attention_autograd_on_card_matches_cpu(cuda, h, hkv, d, window,
                                                    causal):
    """ops.swa_attention under autograd on the card (the GQA groups of
    smollm-135m, internvl2-1b and mixtral, hubert's D = 80 encoder): one
    forward and one backward launch, and the gradients of q, k, v against
    torch's autograd through the twin on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    gen = torch.Generator(device=cuda).manual_seed(h + d)
    q = torch.randn((2, 150, h, d), generator=gen, device=cuda)
    k, v = (torch.randn((2, 150, hkv, d), generator=gen, device=cuda)
            for _ in range(2))
    w = torch.randn((2, 150, h, d), generator=gen, device=cuda)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        fwd, bwd = sw.launches, sw.bwd_launches
        out = ops.swa_attention(*leaves, window=window, causal=causal)
        (out * w.to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (sw.launches - fwd, sw.bwd_launches - bwd) == (1, 1)
        grads[dev] = [x.grad.cpu() for x in leaves]
    for name, g, want in zip("qkv", grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g, want, rtol=3e-5, atol=3e-5, msg=name)


TRAIN_ARCHS = ("smollm-135m", "mixtral-8x22b", "internvl2-1b",
               "hubert-xlarge")


def _train_batch(cfg, k, m, mb, t, seed):
    """A (K, M, mb, ...) batch for any attention family, as CPU tensors."""
    gen = torch.Generator().manual_seed(seed)
    lead = (k, m, mb)
    if cfg.modality == "audio":
        return {"frame_feats": torch.randn(lead + (t, cfg.frontend_dim),
                                           generator=gen),
                "mask_indicator": (torch.rand(lead + (t,), generator=gen)
                                   < 0.3).to(torch.int32),
                "targets": torch.randint(0, cfg.vocab_size, lead + (t,),
                                         generator=gen, dtype=torch.int32)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, lead + (t,),
                                     generator=gen, dtype=torch.int32)}
    if cfg.modality == "vision_text":
        batch["patch_embeds"] = torch.randn(
            lead + (cfg.num_patches, cfg.frontend_dim), generator=gen)
    return batch


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu_route(cuda, arch):
    """One PAOTA round (K = 2, M = 2, client 1 straggling, one noise draw
    for both) of a reduced attention family on the card against the same
    round on the CPU route: every leaf of the store at the LM tolerance;
    per client step one forward and one backward attention launch a
    layer, and one sweep 2 per reference leaf."""
    import copy
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import init_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_reduced(arch)
    k, m, mb, t = 2, 2, 2, 40
    model = init_model(cfg, seed=0, device="cpu")
    store = steps.stack_params(model, k)
    batch = _train_batch(cfg, k, m, mb, t, 1)
    d = sum(x[0].numel() for x in tree_leaves(store))
    draw = torch.randn((d,), generator=torch.Generator().manual_seed(2))
    powers, mask = torch.tensor([3.0, 5.0]), torch.tensor([1.0, 0.0])
    shape = InputShape("t", t, k * mb, "train")
    out = {}
    for dev in ("cuda", "cpu"):
        mod = copy.deepcopy(model).to(dev)
        step = steps.make_paota_train_step(
            mod, shape, k, lr=0.05, local_steps=m,
            noise=lambda key, n, device: draw.to(device))
        counts = (sw.launches, sw.bwd_launches, ac.launches)
        st, metrics = step(tree_map(lambda x: x.to(dev), store),
                           {n: x.to(dev) for n, x in batch.items()},
                           powers.to(dev), mask.to(dev), 0)
        if dev == "cuda":
            torch.cuda.synchronize()
            n_steps = k * m * cfg.num_layers
            assert (sw.launches - counts[0], sw.bwd_launches - counts[1],
                    ac.launches - counts[2]) == (
                        n_steps, n_steps, len(tree_leaves(st)))
        out[dev] = (st, metrics)
    for got, want in zip(tree_leaves(out["cuda"][0]),
                         tree_leaves(out["cpu"][0])):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["cuda"][1]["loss"].cpu(),
                               out["cpu"][1]["loss"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_recurrent_training_on_card_names_the_ssd_backward(cuda, arch):
    """The ssm and hybrid families train on the card through the SSD
    backward kernel: one PAOTA round (K = 2, M = 2, client 1 straggling,
    one noise draw for both; T = 40, no multiple of the 32-token chunk) of
    the reduced config against the same round on the CPU route, every leaf
    at the LM tolerance; per client step one ssd_chunk and one
    ssd_chunk_bwd launch a layer (the hybrid: one swa_attention and one
    swa_attention_bwd a shared slot), one sweep 2 per leaf; nothing falls
    back to the twin."""
    import copy
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import init_model
    from repro_torch.models.transformer import n_shared_slots
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_reduced(arch)
    k, m, mb, t = 2, 2, 2, 40
    model = init_model(cfg, seed=0, device="cpu")
    store = steps.stack_params(model, k)
    batch = _train_batch(cfg, k, m, mb, t, 1)
    d = sum(x[0].numel() for x in tree_leaves(store))
    draw = torch.randn((d,), generator=torch.Generator().manual_seed(2))
    powers, mask = torch.tensor([3.0, 5.0]), torch.tensor([1.0, 0.0])
    shape = InputShape("t", t, k * mb, "train")
    slots = n_shared_slots(cfg) if cfg.family == "hybrid" else 0
    out = {}
    for dev in ("cuda", "cpu"):
        mod = copy.deepcopy(model).to(dev)
        step = steps.make_paota_train_step(
            mod, shape, k, lr=0.05, local_steps=m,
            noise=lambda key, n, device: draw.to(device))
        counts = (sc.launches, sc.bwd_launches, sw.launches,
                  sw.bwd_launches, ac.launches)
        st, metrics = step(tree_map(lambda x: x.to(dev), store),
                           {n: x.to(dev) for n, x in batch.items()},
                           powers.to(dev), mask.to(dev), 0)
        if dev == "cuda":
            torch.cuda.synchronize()
            n_steps = k * m
            assert (sc.launches - counts[0], sc.bwd_launches - counts[1],
                    sw.launches - counts[2], sw.bwd_launches - counts[3],
                    ac.launches - counts[4]) == (
                        n_steps * cfg.num_layers, n_steps * cfg.num_layers,
                        n_steps * slots, n_steps * slots,
                        len(tree_leaves(st)))
        out[dev] = (st, metrics)
    for got, want in zip(tree_leaves(out["cuda"][0]),
                         tree_leaves(out["cpu"][0])):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["cuda"][1]["loss"].cpu(),
                               out["cpu"][1]["loss"], rtol=1e-4, atol=1e-5)


# the SSD backward's cases (Bz, NC, Q, H, G, N, P, offset of B in a conv
# output or None for contiguous B and C, the log-decay's steepness): a
# reduced one, mamba2-370m's train microbatch (2 x 4,096 tokens) and
# zamba2-7b's (1 x 4,096) on views of their conv outputs, a group per head,
# ragged Q / N / P, N and P over one 64-wide tile, views whose rows are no
# 16-byte multiple (staged by plain loads, as are P = 70 and N = 130),
# log-decays steep enough that the -60 clip binds, and zamba2-7b's 112
# heads at N = 64 over one 64-row tile, where every key tile is kt = 0 (a
# dxdt block a head), the kernel's largest chunk (Q = 512), and 17 heads a
# group, whose subsets are single heads (17 partials summed as they land)
SSD_BWD_CASES = {
    "reduced": (2, 3, 64, 8, 2, 32, 32, None, 0.2),
    "mamba2-370m": (2, 16, 256, 32, 1, 128, 64, 2048, 0.2),
    "zamba2-7b": (1, 16, 256, 112, 1, 64, 64, 7168, 0.2),
    "G-eq-H": (2, 2, 64, 4, 4, 32, 32, None, 0.2),
    "ragged": (1, 2, 100, 8, 2, 40, 70, None, 0.2),
    "wide": (1, 1, 200, 4, 1, 130, 72, None, 0.2),
    "unaligned": (1, 2, 100, 8, 2, 40, 64, 3, 0.2),
    "clip": (1, 2, 256, 4, 1, 64, 64, None, 1.0),
    "heads-112-kt0": (1, 4, 64, 112, 1, 64, 64, None, 0.2),
    "q512": (1, 1, 512, 4, 1, 64, 64, None, 0.2),
    "subsets-17": (1, 2, 128, 17, 1, 32, 32, None, 0.2)}
# the cases the backward stages by plain loads (ssd_chunk._bwd_vec16)
SSD_BWD_PLAIN_LOADS = ("ragged", "wide", "unaligned")


def _ssd_bwd_case(dev, name, dtype):
    """cum, b, c, xdt, dy, dstate, ddecay for a SSD_BWD_CASES entry
    (``ssd_chunk.grouped_bwd_example``)."""
    from repro_torch.kernels import ssd_chunk as sc
    bz, nc, q, h, g, n, p, offset, steep = SSD_BWD_CASES[name]
    return sc.grouped_bwd_example(bz, nc, q, h, g, n, p, steep=steep,
                                  dtype=dtype, seed=q + h + n + p,
                                  offset=offset, device=dev)


def _ssd_bwd_close(got, want, dtype):
    """f32 within 2e-5 and bf16 within 2e-2, relative to each gradient's
    largest |value| where that exceeds 1 (dcum sums up to Q^2 terms)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for name, a, w in zip(("dcum", "db", "dc", "dxdt"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(a.float(), w.float(), rtol=tol,
                                   atol=tol * scale, msg=name)


@pytest.mark.parametrize("case", list(SSD_BWD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_matches_twin(cuda, case, dtype):
    """The SSD backward kernel against its plain twin, one count a call,
    bit-identical on repeat, in the staging variant the case's strides
    choose."""
    from repro_torch.kernels import ssd_chunk as sc
    args = _ssd_bwd_case(cuda, case, dtype)
    assert sc._bwd_vec16(*args[1:6]) == (case not in SSD_BWD_PLAIN_LOADS)
    if case == "clip":
        cum = args[0]
        assert bool((cum[:, :, -1] - cum[:, :, 0] < -60.0).any())
    before = sc.bwd_launches
    got = sc.ssd_intra_chunk_grouped_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert sc.bwd_launches == before + 1
    want = sc.ssd_intra_chunk_grouped_bwd_plain(*args)
    _ssd_bwd_close(got, want, dtype)
    again = sc.ssd_intra_chunk_grouped_bwd_cuda(*args)
    for a, w in zip(got, again):
        assert torch.equal(a, w)


def _ssd_forward_f64(cum, b, c, xdt):
    """``ssd_intra_chunk_grouped_plain``'s formulas in f64 (the twin takes
    f32 and bf16 only): (y, state, chunk_decay), differentiable."""
    bz, nc, q, h = cum.shape
    g, n, p = b.shape[3], b.shape[4], xdt.shape[4]
    rep = h // g
    b6 = b.permute(0, 1, 3, 2, 4)[:, :, :, None]
    c6 = c.permute(0, 1, 3, 2, 4)[:, :, :, None]
    x6 = xdt.permute(0, 1, 3, 2, 4).reshape(bz, nc, g, rep, q, p)
    cumh = cum.permute(0, 1, 3, 2).reshape(bz, nc, g, rep, q)
    decay = torch.exp(torch.clamp(cumh[..., :, None] - cumh[..., None, :],
                                  -60.0, 0.0))
    causal = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    scores = torch.where(causal, (c6 @ b6.transpose(-1, -2)) * decay, 0.0)
    y = (scores @ x6).reshape(bz, nc, h, q, p).permute(0, 1, 3, 2, 4)
    tail = torch.exp(torch.clamp(cumh[..., -1:] - cumh, -60.0, 0.0))
    state = x6.transpose(-1, -2) @ (b6 * tail[..., None])
    return (y, state.reshape(bz, nc, h, p, n),
            torch.exp(torch.clamp(cum[:, :, -1], -60.0, 0.0)))


def test_ssd_bwd_large_gradients_f64(cuda):
    """mamba2-370m's chunk (Q 256, N 128, P 64) with 8 heads of one group
    at the default steepness, where the gradients reach ~1e3 (dcum sums
    dS * S over up to Q^2 terms): the kernel's four gradients, f32, and the
    twin's beside them, against torch's f64 autograd of the forward's
    formulas on the same values, each within 2e-5 of its largest |value|
    (3xTF32's partials from zeroed accumulators, summed in depth order,
    must not drift past it)."""
    from repro_torch.kernels import ssd_chunk as sc
    args = sc.grouped_bwd_example(1, 2, 256, 8, 1, 128, 64, seed=11,
                                  device=cuda)
    leaves = [x.double().requires_grad_() for x in args[:4]]
    want = torch.autograd.grad(_ssd_forward_f64(*leaves), leaves,
                               [x.double() for x in args[4:]])
    got = sc.ssd_intra_chunk_grouped_bwd_cuda(*args)
    twin = sc.ssd_intra_chunk_grouped_bwd_plain(*args)
    torch.cuda.synchronize()
    assert float(want[0].abs().max()) > 100.0
    for name, a, t, w in zip(("dcum", "db", "dc", "dxdt"), got, twin, want):
        scale = float(w.abs().max())
        for who, x in (("kernel", a), ("twin", t)):
            torch.testing.assert_close(x.double(), w, rtol=0.0,
                                       atol=2e-5 * scale,
                                       msg=f"{who} {name}")


@pytest.mark.parametrize("case", ["reduced", "unaligned"])
def test_ssd_autograd_on_card_matches_cpu(cuda, case):
    """``ops.ssd_intra_chunk_grouped`` under autograd on the card (the
    forward and the backward kernel, one launch each) against the twin
    under torch's autograd on the CPU: the gradients of the same
    cotangents in cum, xdt and the conv output B and C are views of."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    bz, nc, q, h, g, n, p, offset, _ = SSD_BWD_CASES[case]
    gen = torch.Generator().manual_seed(7)
    cum0 = -torch.cumsum(0.05 + 0.2 * torch.rand((bz, nc, q, h),
                                                 generator=gen), dim=2)
    off = offset or 0
    xbc0 = torch.randn((bz, nc * q, off + 2 * g * n), generator=gen)
    xdt0 = torch.randn((bz, nc, q, h, p), generator=gen)
    cots = [torch.randn(s, generator=gen) for s in (
        (bz, nc, q, h, p), (bz, nc, h, p, n), (bz, nc, h))]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_() for x in (cum0, xbc0, xdt0)]
        cum, xbc, xdt = leaves
        b = xbc[..., off:off + g * n].reshape(bz, nc, q, g, n)
        c = xbc[..., off + g * n:].reshape(bz, nc, q, g, n)
        fwd, bwd = sc.launches, sc.bwd_launches
        outs = ops.ssd_intra_chunk_grouped(cum, b, c, xdt)
        grads[dev] = [x.cpu() for x in torch.autograd.grad(
            outs, leaves, [x.to(dev) for x in cots])]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (sc.launches - fwd, sc.bwd_launches - bwd) == (1, 1)
    for name, a, w in zip(("cum", "xbc", "xdt"), grads["cuda"],
                          grads["cpu"]):
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(a, w, rtol=2e-5, atol=2e-5 * scale,
                                   msg=name)


# The sharded round's partial entry (aircomp_sum.cu repro_aircomp_partial):
# the flat and TP shapes of the sharded paths (K_local = 25 and 250 of the
# paper's d = 8070 at K = 100 and 1000 over 4 ranks; a TP rank's block of
# the MLP's first layer), ragged D, an offset into the flat buffer, and a
# plane one element off 16-byte alignment.
PARTIAL_CASES = [(25, 8070, 0, 1, 0), (250, 8070, 0, 1, 0),
                 (25, 7840, 8070 - 7840 - 10, 2, 0), (2, 3925, 5, 1, 0),
                 (7, 511, 13, 1, 1), (25, 100, 17, 2, 0), (1, 1, 0, 1, 0),
                 (300, 8192, 3, 4, 1)]


@pytest.mark.parametrize("k,d,offset,blocks,misalign", PARTIAL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aircomp_partial_kernel_matches_twin(cuda, k, d, offset, blocks,
                                             misalign, dtype):
    """The kernel against its twin (``bp @ x.float()`` into the same
    places): a whole leaf (blocks = 1) or one TP rank's block of a leaf
    split ``blocks`` ways along its last dim (seg = D / 10 rows of 10,
    pitch = blocks * seg); the raw sum of bp in the last slot; bit-equal
    on repeat; untouched slots stay as they were. The sums are held
    divided by sum bp, as sweep 2's aggregate is (the partial is sweep 2
    before its division), at sweep 2's 3e-5 / 2e-2."""
    from repro_torch.kernels import aircomp_sum as ac
    gen = torch.Generator(device=cuda).manual_seed(7 * k + d)
    x = _plane(gen, k, d, dtype, misalign, cuda)
    m = (torch.rand((k,), generator=gen, device=cuda) < 0.6).float()
    bp = (0.1 + 15.0 * torch.rand((k,), generator=gen, device=cuda)) * m
    seg = d if blocks == 1 or d % 10 else 10
    pitch = seg * blocks
    n = offset + (d // seg - 1) * pitch + seg + 1
    fill = torch.full((n,), -7.0, device=cuda)
    got, again, want = fill.clone(), fill.clone(), fill.clone()
    before = ac.partial_launches
    ac.aircomp_partial_cuda(x, bp, got, offset, seg=seg, pitch=pitch)
    ac.aircomp_partial_cuda(x, bp, again, offset, seg=seg, pitch=pitch)
    torch.cuda.synchronize()
    assert ac.partial_launches == before + 2
    ac.aircomp_partial_plain(x, bp, want, offset, seg=seg, pitch=pitch)
    tol = _tol(dtype) if dtype == torch.bfloat16 else dict(rtol=3e-5,
                                                           atol=3e-5)
    vs = torch.clamp_min(want[-1], 1e-12)
    torch.testing.assert_close(got[:-1] / vs, want[:-1] / vs, **tol)
    torch.testing.assert_close(got[-1], want[-1], rtol=3e-5, atol=0.0)
    assert torch.equal(got, again)
    placed = torch.zeros((n,), dtype=torch.bool, device=cuda)
    placed[-1] = True
    placed.as_strided((d // seg, seg), (pitch, 1), offset).fill_(True)
    assert torch.equal(got[~placed], fill[~placed])


def test_aircomp_partial_tree_on_card_matches_cpu(cuda):
    """The tree entries around the kernel: the flat partial of the MLP's
    six leaves and a TP rank's embedded blocks, on the card against the
    same entry on the CPU (the twin), one launch a leaf."""
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.sharding.tp import TPTopology
    gen = torch.Generator().manual_seed(3)
    shapes = [(25, 10), (25, 784, 10), (25, 10), (25, 10, 10), (25, 10),
              (25, 10, 10)]
    leaves = [torch.randn(s, generator=gen) for s in shapes]
    bp = torch.rand((25,), generator=gen)
    tp = TPTopology(axes=("tp",), extents=(2,), shards=2,
                    leaf_dims=(0, 1, 0, 1, 0, 1), index=1)
    blocks = [leaf.narrow(dim + 1, leaf.shape[dim + 1] // 2,
                          leaf.shape[dim + 1] // 2).contiguous()
              for leaf, dim in zip(leaves, tp.leaf_dims)]
    for fn, args in ((ac.aircomp_partial_tree, (leaves,)),
                     (ac.aircomp_partial_tree_tp, (blocks,))):
        extra = (tp,) if fn is ac.aircomp_partial_tree_tp else ()
        want = fn(*args, bp, *extra)
        before = ac.partial_launches
        got = fn([t.to(cuda) for t in args[0]], bp.to(cuda), *extra)
        torch.cuda.synchronize()
        assert ac.partial_launches == before + 6
        torch.testing.assert_close(got.cpu(), want, rtol=3e-5, atol=3e-5)
