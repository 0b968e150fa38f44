"""Port's attention backward, CPU side: ``swa_attention_bwd_plain`` (the
twin the backward kernel is held against on the card) against ``jax.vjp``
of the reference's ``_flash`` (its custom VJP, ``_flash_bwd``) at small
chunks, and against torch's autograd through ``swa_attention_plain``;
causal, windowed, bidirectional, GQA, rows with no key. The band plan
transposed (``band_plan_t``, the dK / dV pass's, with the interior query
tiles it runs unmasked) and the forward plan at the backward's 64 x 64
tiles (the dQ pass's) against ``band_mask``. Inputs
come from fixed numpy seeds; tolerance is the reference's kernel one. The
CUDA kernel is held against the twin in tests/test_torch_cuda.py and
chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.layers import _flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)     # tests/test_kernels.py's swa tolerance


def _inputs(b, t, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, hkv, d)).astype(np.float32)
            for _ in range(2))
    dout = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return q, k, v, dout


def _rows(x):
    """(B, T, H, D) numpy -> the kernel's (B H, T, D) torch layout."""
    b, t, h, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(b * h, t, d)))


def _bthd(x, b, h):
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2).numpy()


# (T, H, Hkv, D, window, causal, chunk): causal, windowed, bidirectional
# with and without a window, GQA groups of 3 and 7, T over several chunks.
# T is a multiple of the chunk: where it is not, the reference's
# _flash_bwd returns the padded key positions' zero cotangent and jax
# refuses its shape (a reference-side fact).
FLASH_CASES = [(40, 2, 2, 16, None, True, 8), (50, 2, 2, 32, 12, True, 10),
               (40, 2, 2, 16, None, False, 8), (48, 2, 2, 8, 9, False, 16),
               (45, 6, 2, 16, 20, True, 15), (35, 7, 1, 8, None, True, 7)]


@pytest.mark.parametrize("t,h,hkv,d,window,causal,chunk", FLASH_CASES)
def test_bwd_twin_matches_reference_flash_vjp(t, h, hkv, d, window, causal,
                                              chunk):
    b = 2
    q, k, v, dout = _inputs(b, t, h, hkv, d, t + h + d)
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.float32)[None], (b, t))
    out, vjp = jax.vjp(lambda q, k, v: _flash(q, k, v, pos, pos, window,
                                              causal, chunk),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    # the port: GQA repeat, (B H, T, D) rows, the twin's forward with its
    # log-sum-exp, the backward twin, the repeat's gradient summed back
    qr, kr, vr = ops.swa_layout(*(torch.from_numpy(x) for x in (q, k, v)))
    o, lse = sw.swa_attention_plain(qr, kr, vr, window=window,
                                    causal=causal, return_lse=True)
    np.testing.assert_allclose(_bthd(o, b, h), np.asarray(out), **TOL)
    dq, dk, dv = sw.swa_attention_bwd_plain(qr, kr, vr, o, _rows(dout), lse,
                                            window=window, causal=causal)
    g = h // hkv
    got = [_bthd(dq, b, h)] + [
        _bthd(x, b, h).reshape(b, t, hkv, g, d).sum(3) for x in (dk, dv)]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)


# (T, S, D, window, causal): the kernel card cases' kinds at small sizes,
# rows with no key among them (W = 0; T > S with a window)
AUTOGRAD_CASES = [(40, 40, 16, None, True), (50, 60, 16, 7, False),
                  (60, 50, 32, 20, True), (30, 30, 8, None, False),
                  (20, 20, 8, 0, True), (70, 30, 16, 10, True)]


@pytest.mark.parametrize("t,s,d,window,causal", AUTOGRAD_CASES)
def test_bwd_twin_matches_torch_autograd(t, s, d, window, causal):
    """The twin against torch's own backward through swa_attention_plain
    on the same inputs; a row with no key gets zero gradients."""
    rng = np.random.default_rng(t + s + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, n, d)).astype(
        np.float32)) for n in (t, s, s))
    dout = torch.from_numpy(rng.normal(size=(3, t, d)).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = sw.swa_attention_plain(*leaves, window=window, causal=causal,
                                      return_lse=True)
    out.backward(dout)
    got = sw.swa_attention_bwd_plain(q, k, v, out.detach(), dout,
                                     lse.detach(), window=window,
                                     causal=causal)
    for name, a, x in zip("qkv", got, leaves):
        torch.testing.assert_close(a, x.grad, **TOL, msg=name)
    rows = sw.band_mask(t, s, window, causal, "cpu").any(-1)
    assert not got[0][:, ~rows].any()
    assert bool((lse[:, ~rows] <= -1e29).all())


def test_ops_autograd_with_gqa_matches_per_head_twin():
    """ops.swa_attention under autograd on the CPU (the twin, GQA 3): dK and
    dV are the per-query-head backward twin's summed over each kv head's
    group."""
    b, t, h, hkv, d = 2, 33, 6, 2, 16
    q, k, v, dout = _inputs(b, t, h, hkv, d, 5)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.swa_attention(*leaves, window=11)
    out.backward(torch.from_numpy(dout))
    qr, kr, vr = ops.swa_layout(*(torch.from_numpy(x) for x in (q, k, v)))
    o, lse = sw.swa_attention_plain(qr, kr, vr, window=11, return_lse=True)
    dq, dk, dv = sw.swa_attention_bwd_plain(qr, kr, vr, o, _rows(dout), lse,
                                            window=11)
    want = [_bthd(dq, b, h)] + [
        _bthd(x, b, h).reshape(b, t, hkv, h // hkv, d).sum(3)
        for x in (dk, dv)]
    for name, x, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), w, **TOL, err_msg=name)


def test_bwd_refuses_head_dims_past_128_by_name():
    q = torch.zeros((1, 4, 256))
    lse = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="head dim 256"):
        sw.swa_attention_bwd_plain(q, q, q, q, q, lse)
    q = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="lse"):
        sw.swa_attention_bwd_plain(q, q, q, q, q, lse[:, :3])


PLAN_TS = [(130, 130), (100, 170), (170, 100), (256, 256), (65, 300),
           (1500, 1500)]
PLAN_WINDOWS = [None, 0, 1, 63, 64, 65, 1000]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", PLAN_WINDOWS)
@pytest.mark.parametrize("t,s", PLAN_TS)
def test_transposed_band_plan_matches_band_mask(t, s, window, causal):
    """Per key tile, [lo, hi) in query tiles holds every query that sees the
    tile, and its first and last tiles hold one each (none: lo = hi); the
    interior [ilo, ihi) inside it is exactly the query tiles that lie in T,
    face a key tile inside S and hold allowed pairs only (the kernel runs
    them unmasked), and the edge tiles [lo, ilo) and [ihi, hi) hold the
    tile's other allowed pairs; the forward plan at the backward's tiles
    visits exactly the key tiles with an allowed pair."""
    mask = sw.band_mask(t, s, window, causal, "cpu")
    for bq, bk in ((sw.BWD_BLOCK, sw.BWD_BLOCK), (16, 8)):
        plan = sw.band_plan_t(t, s, window, causal, bq, bk)
        assert plan.dtype == torch.int32
        assert tuple(plan.shape) == (-(-s // bk), 4)
        for kt, (lo, ilo, ihi, hi) in enumerate(plan.tolist()):
            block = mask[:, kt * bk:(kt + 1) * bk]
            cols = block.any(-1)
            tiles = [i for i in range(-(-t // bq))
                     if cols[i * bq:(i + 1) * bq].any()]
            assert tiles == list(range(lo, hi)), (kt, lo, hi)
            assert lo <= ilo <= ihi <= hi, (kt, lo, ilo, ihi, hi)
            full = [i for i in tiles if (i + 1) * bq <= t
                    and (kt + 1) * bk <= s
                    and bool(block[i * bq:(i + 1) * bq].all())]
            assert full == list(range(ilo, ihi)), (kt, ilo, ihi, full)
            edge = block.clone()
            edge[ilo * bq:ihi * bq] = False
            rows = torch.arange(t)
            assert not (edge & ~((rows >= lo * bq) & (rows < hi * bq))[
                :, None]).any(), kt
        fwd = sw.band_plan(t, s, window, causal, bq, bk)
        for qt, (lo, _, _, hi) in enumerate(fwd.tolist()):
            rows = mask[qt * bq:(qt + 1) * bq].any(0)
            tiles = [j for j in range(-(-s // bk))
                     if rows[j * bk:(j + 1) * bk].any()]
            assert tiles == list(range(lo, hi)), (qt, lo, hi)
