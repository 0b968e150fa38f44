"""Port's sliding-window attention, CPU side: the plain twin against the
reference's oracle and its Pallas kernel (interpret mode) on the
reference's sweep, and the (B, T, H, D) entry point with the GQA repeat
against the reference's ``ops.swa_attention``, on the same numpy inputs at
the reference's tolerances. The CUDA kernel is held against the same twin
on the card (chip_smoke.py, tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import swa_attention_ref  # noqa: E402
from repro.kernels.swa_attention import swa_attention_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402

RNG = np.random.default_rng(42)
TOL = dict(rtol=3e-5, atol=3e-5)     # tests/test_kernels.py's swa tolerance

SWEEP = [(128, 128, 64, None, True, 64, 64),
         (200, 200, 32, 64, True, 64, 64),
         (256, 256, 64, 96, True, 128, 64),
         (256, 256, 128, 128, True, 128, 128),
         (64, 64, 16, None, False, 32, 32),     # encoder (bidirectional)
         (96, 96, 64, 32, True, 32, 32),
         (130, 130, 64, 64, True, 64, 64)]      # ragged T


@pytest.mark.parametrize("t,s,d,window,causal,bq,bk", SWEEP)
def test_swa_twin_matches_reference_oracle_and_pallas(t, s, d, window,
                                                      causal, bq, bk):
    q, k, v = (RNG.normal(size=(3, n, d)).astype(np.float32)
               for n in (t, s, s))
    got = sw.swa_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                 window=window, causal=causal)
    want = swa_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, causal=causal)
    pallas = swa_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  causal=causal, block_q=bq, block_k=bk,
                                  interpret=True)
    oracle = ref.swa_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   window=window, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


def test_swa_twin_bf16():
    """tests/test_kernels.py::test_swa_attention_bf16 on the twin: bf16 in,
    bf16 out, against the f32 oracle on the same rounded values."""
    q, k, v = (jnp.asarray(RNG.normal(size=(2, 128, 64)), jnp.bfloat16)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(np.asarray(a).view(np.uint16).astype(
        np.int16)).view(torch.bfloat16) for a in (q, k, v))
    got = sw.swa_attention_plain(tq, tk, tv, window=64)
    assert got.dtype == torch.bfloat16
    want = swa_attention_ref(q.astype(jnp.float32), k.astype(jnp.float32),
                             v.astype(jnp.float32), window=64)
    pallas = swa_attention_pallas(q, k, v, window=64, block_q=64,
                                  block_k=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_swa_twin_rows_without_keys_are_zero():
    q, k, v = (torch.from_numpy(RNG.normal(size=(2, 40, 16)).astype(
        np.float32)) for _ in range(3))
    out = sw.swa_attention_plain(q, k, v, window=0)
    assert torch.equal(out, torch.zeros_like(out))
    np.testing.assert_allclose(
        out.numpy(), ref.swa_attention_ref(q, k, v, window=0).numpy())


@pytest.mark.parametrize("window,causal", [(None, True), (40, True),
                                           (None, False)])
def test_gqa_entry_point_matches_reference(window, causal):
    """tests/test_kernels.py::test_model_attention_matches_kernel's setup
    (the reduced smollm-135m's heads: 4 query over 1 kv, D = 32, T = 96),
    through both packages' ops.swa_attention."""
    from repro.configs import get_reduced
    cfg = get_reduced("smollm-135m")
    rng = np.random.default_rng(0)
    b, t = 2, 96
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert h != hkv
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    want = jops.swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=window, causal=causal, block_q=32,
                              block_k=32)
    got = ops.swa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            window=window, causal=causal)
    assert tuple(got.shape) == (b, t, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros((2, 8, 4), dtype=torch.float64)), "dtypes"),
    (dict(k=torch.zeros((2, 8, 5)), v=torch.zeros((2, 8, 5))), "k shape"),
    (dict(v=torch.zeros((2, 9, 4))), "shape"),
    (dict(q=torch.zeros((2, 8, 300)), k=torch.zeros((2, 8, 300)),
          v=torch.zeros((2, 8, 300))), "head dim"),
    (dict(window=-1), "window"),
    (dict(q=torch.zeros((2, 4, 8)).transpose(1, 2)), "contiguous")])
def test_swa_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = dict(q=torch.zeros((2, 8, 4)), k=torch.zeros((2, 8, 4)),
                v=torch.zeros((2, 8, 4)), window=None)
    args.update(bad)
    window = args.pop("window")
    with pytest.raises((TypeError, ValueError), match=match):
        sw.swa_attention_cuda(**args, window=window)


@pytest.mark.parametrize("t,s,d,window", [(150, 150, 40, 33),
                                          (96, 200, 32, 48)])
def test_swa_twin_windowed_bidirectional_matches_reference_oracle(t, s, d,
                                                                  window):
    """A window with causal off: query t attends to every key s > t - W,
    later keys included, as the reference's oracle defines it. The
    reference's Pallas kernel visits only (W + BQ) // BK + 1 key stripes
    from the window's start, so it drops keys beyond them on such inputs;
    the port follows the oracle (the CUDA kernel visits [q0 - W + 1, S))."""
    q, k, v = (RNG.normal(size=(2, n, d)).astype(np.float32)
               for n in (t, s, s))
    got = sw.swa_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                 window=window, causal=False)
    want = swa_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = swa_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  causal=False, block_q=32, block_k=32,
                                  interpret=True)
    # the known disagreement between the reference's kernel and its oracle
    assert np.abs(np.asarray(pallas) - np.asarray(want)).max() > 0.1


# The band plan the CUDA kernel reads (band_plan), held against band_mask:
# T != S and ragged T and S, windows around the 64-key tile (and 0, where no
# row has a key, and W > T), causal on and off, at both tile shapes the
# kernel instantiates (tiles()).
PLAN_TS = [(130, 130), (100, 170), (170, 100), (256, 256), (65, 300)]
PLAN_WINDOWS = [None, 0, 1, 63, 64, 65, 1000]
KERNEL_TILES = sorted({sw.tiles(d)[1:] for d in range(1, 257)})


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", PLAN_WINDOWS)
@pytest.mark.parametrize("t,s", PLAN_TS)
def test_band_plan_matches_band_mask(t, s, window, causal):
    mask = sw.band_mask(t, s, window, causal, "cpu")
    for block_q, block_k in KERNEL_TILES:
        plan = sw.band_plan(t, s, window, causal, block_q, block_k)
        assert plan.dtype == torch.int32
        assert tuple(plan.shape) == (-(-t // block_q), 4)
        covered = torch.zeros_like(mask)
        for qt, (lo, ilo, ihi, hi) in enumerate(plan.tolist()):
            assert lo <= ilo <= ihi <= hi
            rows = slice(qt * block_q, (qt + 1) * block_q)
            for j in range(-(-s // block_k)):
                keys = slice(j * block_k, (j + 1) * block_k)
                tile = mask[rows, keys]
                if lo <= j < hi:
                    covered[rows, keys] = True
                    # no visited tile is empty: the cost is the band's
                    assert tile.any()
                else:
                    assert not tile.any(), (qt, j)
                if ilo <= j < ihi:
                    assert (j + 1) * block_k <= s and tile.all(), (qt, j)
        # every allowed pair lies in a visited tile
        assert not (mask & ~covered).any()


def test_band_plan_edges_at_the_main_shape():
    """T = S = 8192, W = 4096, causal, the f32 D = 128 tiles: a query tile
    visits at most 66 key tiles, of which at most 4 carry a mask (two at the
    window's start, two on the diagonal); the first tile has edges only."""
    _, block_q, block_k = sw.tiles(128)
    plan = sw.band_plan(8192, 8192, 4096, True, block_q, block_k)
    lo, ilo, ihi, hi = plan.T
    assert int((hi - lo).max()) == 66
    assert int(((hi - lo) - (ihi - ilo)).max()) == 4
    assert plan[0].tolist() == [0, 0, 0, 2]


def test_tiles_cover_every_head_dim():
    for d in range(1, sw.MAX_HEAD_DIM + 1):
        dp, block_q, block_k = sw.tiles(d)
        assert dp in sw.HEAD_DIMS and d <= dp and dp % 16 == 0
        assert block_q % 16 == 0 and block_k % 16 == 0


# 3xTF32 in plain torch, the kernel's f32 precision scheme: hi rounds to
# TF32 with ties away from zero (cvt.rna), by integer ops on the f32 bits;
# the tensor cores read lo = x - hi truncated to TF32; a product is
# lo * hi + hi * lo + hi * hi.
def _tf32_rna(x):
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(x):
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _attention_tf32(q, k, v, window, causal, passes):
    mask = sw.band_mask(q.shape[1], k.shape[1], window, causal, "cpu")
    logits = _mm_tf32(q, k.transpose(1, 2), passes)
    logits.mul_(torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=torch.float32))
    logits.masked_fill_(~mask, sw.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs.masked_fill_(~mask.any(-1, keepdim=True), 0.0)
    return _mm_tf32(probs, v, passes)


def test_tf32_rounding_is_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between two TF32 values: up, and down for -x
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0, 3.0])
    assert torch.equal(_tf32_rna(x), want)
    lo = x - _tf32_rna(x)
    assert torch.equal(_tf32_rna(x) + lo, x)


@pytest.mark.parametrize("amp", [1.0, 2.0])
@pytest.mark.parametrize("t,s,d,window,causal", [
    case[:5] for case in SWEEP] + [(256, 256, 112, 128, True),
                                   (100, 170, 48, 40, True)])
def test_3xtf32_attention_within_the_kernel_tolerance(t, s, d, window,
                                                      causal, amp):
    """The f32 kernel's products in 3xTF32 (emulated) stay within 3e-5 of
    the twin at the sweep's shapes and zamba2's D = 112, for q, k, v of
    scale 1 and 2; one TF32 pass does not."""
    rng = np.random.default_rng(t + s + d)
    q, k, v = (torch.from_numpy((amp * rng.normal(size=(3, n, d))).astype(
        np.float32)) for n in (t, s, s))
    want = sw.swa_attention_plain(q, k, v, window=window, causal=causal)
    got = _attention_tf32(q, k, v, window, causal, passes=3)
    torch.testing.assert_close(got, want, **TOL)
    one_pass = _attention_tf32(q, k, v, window, causal, passes=1)
    assert float((one_pass - want).abs().max()) > 1e-4
