"""Port's Mamba2 SSD, CPU side: the intra-chunk twin against the
reference's oracle and its Pallas kernel (interpret mode), the chunked SSD
forward against the reference's (both of its branches) and the naive
recurrence, and the Mamba2 block (prefill and decode, with states) on the
reduced mamba2-370m, all on the same numpy inputs at the reference's
tolerances. The CUDA kernel is held against the same twin on the card
(chip_smoke.py, tests/test_torch_cuda.py)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.kernels.ref import ssd_intra_chunk_ref  # noqa: E402
from repro.kernels.ssd_chunk import ssd_intra_chunk_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py's ssd tolerance


def _t(a):
    return torch.from_numpy(np.array(a))


def _sweep_inputs(g, q, n, d):
    """tests/test_kernels.py::test_ssd_intra_chunk_sweep's inputs."""
    rng = np.random.default_rng(g + q)
    cum = -np.cumsum(0.05 + 0.2 * rng.random((g, q)), axis=1).astype(
        np.float32)
    b = rng.normal(size=(g, q, n)).astype(np.float32)
    c = rng.normal(size=(g, q, n)).astype(np.float32)
    xdt = rng.normal(size=(g, q, d)).astype(np.float32)
    return cum, b, c, xdt


@pytest.mark.parametrize("g,q,n,d", [(4, 32, 16, 32), (8, 64, 128, 64),
                                     (2, 256, 64, 64), (3, 128, 64, 32)])
def test_ssd_twin_matches_reference_oracle_pallas_and_f64(g, q, n, d):
    arrs = _sweep_inputs(g, q, n, d)
    got = ops.ssd_intra_chunk(*(_t(a) for a in arrs))
    want = ssd_intra_chunk_ref(*(jnp.asarray(a) for a in arrs))
    pallas = ssd_intra_chunk_pallas(*(jnp.asarray(a) for a in arrs),
                                    interpret=True)
    oracle = ref.ssd_intra_chunk_ref(*(_t(a) for a in arrs))
    assert [tuple(x.shape) for x in got] == [(g, q, d), (g, n, d), (g,)]
    for out, a, w, p, o in zip(("y", "state", "chunk_decay"), got, want,
                               pallas, oracle):
        assert a.dtype == torch.float32
        # each comparison names itself, and the reference's two sides are
        # also held against the f64 oracle, so a failure tells which side
        # moved: the port's twin or the JAX reference
        for side, val in (("port twin", a.numpy()),
                          ("JAX ssd_intra_chunk_ref", np.asarray(w)),
                          ("Pallas interpret", np.asarray(p))):
            np.testing.assert_allclose(
                val, o.numpy(), **TOL,
                err_msg=f"{out}: {side} vs the torch f64 oracle")
        np.testing.assert_allclose(
            a.numpy(), np.asarray(w), **TOL,
            err_msg=f"{out}: port twin vs JAX ssd_intra_chunk_ref")
        np.testing.assert_allclose(
            a.numpy(), np.asarray(p), **TOL,
            err_msg=f"{out}: port twin vs Pallas interpret")


def test_ssd_twin_bf16_inputs_give_bf16_y():
    cum, b, c, xdt = _sweep_inputs(3, 64, 32, 16)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (b, c, xdt)]
    y, state, decay = sc.ssd_intra_chunk_plain(_t(cum), *bf)
    assert (y.dtype, state.dtype, decay.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    oy, ost, _ = ref.ssd_intra_chunk_ref(_t(cum), *(t.float() for t in bf))
    np.testing.assert_allclose(y.float().numpy(), oy.numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(state.numpy(), ost.numpy(), **TOL)


@pytest.mark.parametrize("bad,match", [
    (dict(cum=torch.zeros((2, 8), dtype=torch.float64)), "cum dtype"),
    (dict(b=torch.zeros((2, 8, 4), dtype=torch.bfloat16)), "dtypes differ"),
    (dict(xdt=torch.zeros((2, 7, 4))), "xdt shape"),
    (dict(c=torch.zeros((2, 8, 3))), "c shape"),
    (dict(b=torch.zeros((2, 4, 8)).transpose(1, 2)), "contiguous")])
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = dict(cum=torch.zeros((2, 8)), b=torch.zeros((2, 8, 4)),
                c=torch.zeros((2, 8, 4)), xdt=torch.zeros((2, 8, 4)))
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        sc.ssd_intra_chunk_cuda(**args)


def _grouped_inputs(seed, bz, nc, q, h, g, n, p, valid=None):
    """Grouped SSD inputs as ``ssd_chunked`` forms them: cum (Bz, NC, Q, H)
    a decreasing cumulative log-decay, B, C (Bz, NC, Q, G, N) and xdt
    (Bz, NC, Q, H, P) standard normal. With ``valid`` tokens of NC*Q, the
    rest is the chunk padding of a ragged prompt: zero B, C, xdt and dt
    (so cum stays flat)."""
    rng = np.random.default_rng(seed)
    da = -(0.05 + 0.2 * rng.random((bz, nc * q, h)))
    b = rng.normal(size=(bz, nc * q, g, n))
    c = rng.normal(size=(bz, nc * q, g, n))
    xdt = rng.normal(size=(bz, nc * q, h, p))
    if valid is not None:
        for a in (da, b, c, xdt):
            a[:, valid:] = 0.0
    cum = np.cumsum(da.reshape(bz, nc, q, h), axis=2)
    return [a.astype(np.float32) for a in (
        cum, b.reshape(bz, nc, q, g, n), c.reshape(bz, nc, q, g, n),
        xdt.reshape(bz, nc, q, h, p))]


def _flatten_for_reference(cum, b, c, xdt):
    """The reference's kernel-branch layout: B and C repeated over the
    heads, (G = Bz * NC * H, Q, .)."""
    bz, nc, q, h = cum.shape
    rep = h // b.shape[3]
    bh = np.repeat(b, rep, axis=3).transpose(0, 1, 3, 2, 4)
    ch = np.repeat(c, rep, axis=3).transpose(0, 1, 3, 2, 4)
    return (cum.transpose(0, 1, 3, 2).reshape(-1, q),
            bh.reshape(-1, q, b.shape[4]), ch.reshape(-1, q, c.shape[4]),
            xdt.transpose(0, 1, 3, 2, 4).reshape(-1, q, xdt.shape[4]))


@pytest.mark.parametrize("g,h", [(1, 4), (2, 8), (4, 4), (1, 1), (2, 2)],
                         ids=["G1-rep4", "G2-rep4", "GH-rep1", "G1-rep1",
                              "G2-rep1"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_twin_matches_reference_pallas(g, h, ragged, dtype):
    """The grouped twin against the reference's Pallas kernel (interpret
    mode) on the repeated and flattened inputs: G in {1, 2, H}, rep in
    {1, 4}, a ragged prompt's chunk padding (75 of 96 tokens), f32 at 2e-5
    and bf16 inputs at 2e-2."""
    bz, nc, q, n, p = 2, 3, 32, 16, 8
    arrs = _grouped_inputs(g * 10 + h, bz, nc, q, h, g, n, p,
                           valid=75 if ragged else None)
    tt = [_t(arrs[0])] + [_t(a).to(dtype) for a in arrs[1:]]
    y, state, decay = ops.ssd_intra_chunk_grouped(*tt)
    assert (tuple(y.shape), tuple(state.shape), tuple(decay.shape)) == (
        (bz, nc, q, h, p), (bz, nc, h, p, n), (bz, nc, h))
    assert (y.dtype, state.dtype, decay.dtype) == (dtype, torch.float32,
                                                   torch.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    flat = _flatten_for_reference(*(a if i == 0 else
                                    np.asarray(jnp.asarray(a, jdt))
                                    for i, a in enumerate(arrs)))
    jy, jst, jdec = ssd_intra_chunk_pallas(
        jnp.asarray(flat[0]), *(jnp.asarray(a, jdt) for a in flat[1:]),
        interpret=True)
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    want_y = np.asarray(jy, np.float32).reshape(bz, nc, h, q, p)
    np.testing.assert_allclose(y.float().numpy(),
                               want_y.transpose(0, 1, 3, 2, 4), **tol)
    want_st = np.asarray(jst).reshape(bz, nc, h, n, p)
    np.testing.assert_allclose(state.numpy(),
                               want_st.transpose(0, 1, 2, 4, 3), **TOL)
    np.testing.assert_allclose(decay.numpy(),
                               np.asarray(jdec).reshape(bz, nc, h), **TOL)


@pytest.mark.parametrize("g,q,n,d", [(4, 32, 16, 32), (3, 100, 40, 70)])
def test_adapter_equals_the_grouped_twin_bit_for_bit(g, q, n, d):
    """The reference-shaped entry is the grouped function with H = G = 1:
    its outputs are the grouped twin's, bit for bit."""
    cum, b, c, xdt = (_t(a) for a in _sweep_inputs(g, q, n, d))
    got = ops.ssd_intra_chunk(cum, b, c, xdt)
    y, state, decay = sc.ssd_intra_chunk_grouped_plain(
        cum.view(g, 1, q, 1), b.view(g, 1, q, 1, n), c.view(g, 1, q, 1, n),
        xdt.view(g, 1, q, 1, d))
    assert torch.equal(got[0], y.view(g, q, d))
    assert torch.equal(got[1], state.view(g, d, n).transpose(1, 2))
    assert torch.equal(got[2], decay.view(g))


@pytest.mark.parametrize("bad,match", [
    (dict(b=torch.zeros((1, 2, 8, 3, 4)), c=torch.zeros((1, 2, 8, 3, 4))),
     "do not divide"),
    (dict(b=torch.zeros((1, 2, 8, 4, 2)).transpose(3, 4)), "along N"),
    (dict(xdt=torch.zeros((1, 2, 8, 5, 4)).transpose(3, 4)), "contiguous"),
    (dict(cum=torch.zeros((1, 1, 520, 4))), "exceeds"),
    (dict(c=torch.zeros((1, 2, 8, 2, 2), dtype=torch.bfloat16)),
     "dtypes differ")])
def test_grouped_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = dict(cum=torch.zeros((1, 2, 8, 4)), b=torch.zeros((1, 2, 8, 2, 2)),
                c=torch.zeros((1, 2, 8, 2, 2)),
                xdt=torch.zeros((1, 2, 8, 4, 5)))
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        sc.ssd_intra_chunk_grouped_cuda(**args)


def test_ssd_chunked_hands_b_and_c_as_views_of_the_conv_output(monkeypatch):
    """The prefill path builds no (..., H, N) copy of B or C: the tensors
    handed to the kernel seam are views of the conv output's storage, one
    slice per group, not per head."""
    jp, tp = _block(0)
    cfg = get_reduced("mamba2-370m")
    seen = {}
    conv, grouped = tssm._causal_conv, ops.ssd_intra_chunk_grouped

    def spy_conv(*a, **kw):
        out = conv(*a, **kw)
        seen["xbc"] = out[0]
        return out

    def spy_grouped(cum, b, c, xdt):
        seen["b"], seen["c"] = b, c
        return grouped(cum, b, c, xdt)

    monkeypatch.setattr(tssm, "_causal_conv", spy_conv)
    monkeypatch.setattr(ops, "ssd_intra_chunk_grouped", spy_grouped)
    t = min(cfg.ssm_chunk, 32)
    u = _t(np.random.default_rng(2).normal(size=(2, t, cfg.d_model)).astype(
        np.float32))
    tssm.apply_mamba2(tp, u, cfg)
    base = seen["xbc"].untyped_storage().data_ptr()
    for name in ("b", "c"):
        x = seen[name]
        assert x.untyped_storage().data_ptr() == base, name
        assert not x.is_contiguous(), name
        assert x.shape[3] == cfg.ssm_ngroups != cfg.ssm_nheads, name


def _ssd_inputs(seed, bz, t, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bz, t, h, p)).astype(np.float32)
    dt = (0.1 + 0.5 * rng.random((bz, t, h))).astype(np.float32)
    a = -(0.5 + rng.random(h)).astype(np.float32)
    B = rng.normal(size=(bz, t, g, n)).astype(np.float32)
    C = rng.normal(size=(bz, t, g, n)).astype(np.float32)
    return x, dt, a, B, C


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("t,g", [(49, 1), (32, 2)])
def test_ssd_chunked_matches_reference(use_kernel, t, g):
    """T = 49 with chunk 16 pads the last chunk (the reference's own
    kernel-backend test); G = 2 groups repeat B and C over the heads."""
    jcfg = dataclasses.replace(j_get_reduced("mamba2-370m"), ssm_chunk=16)
    tcfg = dataclasses.replace(get_reduced("mamba2-370m"), ssm_chunk=16)
    arrs = _ssd_inputs(5, 2, t, 4, 8, g, 16)
    init = np.random.default_rng(6).normal(size=(2, 4, 8, 16)).astype(
        np.float32)
    ref_fn = jax.jit(lambda *a, s=None: jssm.ssd_chunked(
        *a, jcfg, s, use_kernel=use_kernel))
    for init_state in (None, init):
        y0, s0 = ref_fn(
            *(jnp.asarray(a) for a in arrs),
            s=None if init_state is None else jnp.asarray(init_state))
        y1, s1 = tssm.ssd_chunked(
            *(_t(a) for a in arrs), tcfg,
            None if init_state is None else _t(init_state))
        np.testing.assert_allclose(y1.numpy(), np.asarray(y0), **TOL)
        np.testing.assert_allclose(s1.numpy(), np.asarray(s0), **TOL)


def test_ssd_chunked_matches_naive_recurrence():
    """tests/test_archs.py::test_ssd_chunked_matches_naive_recurrence on the
    port (T = 67, chunk 16), in float64 for the recurrence."""
    cfg = dataclasses.replace(get_reduced("mamba2-370m"), ssm_chunk=16)
    bz, t, h, p, g, n = 2, 67, 4, 8, 1, 16
    x, dt, a, B, C = _ssd_inputs(1, bz, t, h, p, g, n)
    y, fs = tssm.ssd_chunked(_t(x), _t(dt), _t(a), _t(B), _t(C), cfg)
    Bh = np.repeat(B, h // g, axis=2).astype(np.float64)
    Ch = np.repeat(C, h // g, axis=2).astype(np.float64)
    S = np.zeros((bz, h, p, n))
    ys = []
    for i in range(t):
        decay = np.exp(dt[:, i] * a[None, :].astype(np.float64))
        S = S * decay[:, :, None, None] + np.einsum(
            "bhn,bhp->bhpn", Bh[:, i], x[:, i] * dt[:, i][..., None])
        ys.append(np.einsum("bhn,bhpn->bhp", Ch[:, i], S))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(fs.numpy(), S, atol=3e-4, rtol=3e-4)


def _block(seed):
    """The reference's init_mamba2 params on the reduced config, as numpy
    and as the port's dict of tensors."""
    cfg = j_get_reduced("mamba2-370m")
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), cfg, jnp.float32)
    # the init leaves a_log, dt_bias and skip_d constant; vary them
    rng = np.random.default_rng(seed)
    h = cfg.ssm_nheads
    jp = dict(jp, a_log=jnp.asarray(rng.normal(size=h) * 0.3, jnp.float32),
              dt_bias=jnp.asarray(-2.0 + rng.normal(size=h), jnp.float32),
              skip_d=jnp.asarray(1.0 + rng.normal(size=h) * 0.1,
                                 jnp.float32))
    return jp, {k: _t(v) for k, v in jp.items()}


def _states(seed, b):
    cfg = get_reduced("mamba2-370m")
    rng = np.random.default_rng(seed)
    d_in, h, p, g, n, d_xbc = tssm._dims(cfg)
    return {"ssm": rng.normal(size=(b, h, p, n)).astype(np.float32),
            "conv": rng.normal(size=(b, cfg.conv_kernel - 1,
                                     d_xbc)).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 40, 64])
def test_apply_mamba2_matches_reference(with_state, t):
    jp, tp = _block(0)
    jcfg, tcfg = j_get_reduced("mamba2-370m"), get_reduced("mamba2-370m")
    u = np.random.default_rng(t).normal(size=(2, t, tcfg.d_model)).astype(
        np.float32)
    st = _states(t, 2) if with_state else None
    jout, jst = jax.jit(lambda p, u, s: jssm.apply_mamba2(p, u, jcfg, s))(
        jp, jnp.asarray(u),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    tout, tst = tssm.apply_mamba2(
        tp, _t(u), tcfg, None if st is None else {k: _t(v)
                                                  for k, v in st.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)


def test_apply_mamba2_decode_matches_reference_over_steps():
    jp, tp = _block(1)
    jcfg, tcfg = j_get_reduced("mamba2-370m"), get_reduced("mamba2-370m")
    st = _states(3, 2)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: _t(v) for k, v in st.items()}
    rng = np.random.default_rng(4)
    step = jax.jit(lambda p, u, s: jssm.apply_mamba2_decode(p, u, s, jcfg))
    for _ in range(4):
        u = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        jout, jst = step(jp, jnp.asarray(u), jst)
        tout, tst = tssm.apply_mamba2_decode(tp, _t(u), tst, tcfg)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       **TOL)


def test_init_mamba2_shapes_and_scales_match_reference():
    jcfg, tcfg = j_get_reduced("mamba2-370m"), get_reduced("mamba2-370m")
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = tssm.init_mamba2(torch.Generator().manual_seed(0), tcfg,
                          torch.float32)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32
        j, t = np.asarray(jp[k]), tp[k].numpy()
        if np.all(j == j.flat[0]):        # a_log, dt_bias, skip_d, norm_scale
            np.testing.assert_array_equal(t, j)
        else:                              # the same scale of normal draws
            assert abs(t.std() / j.std() - 1.0) < 0.1, k
