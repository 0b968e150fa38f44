"""The SSD intra-chunk backward on the CPU: the port's plain backward twin
(``ssd_intra_chunk_grouped_bwd_plain``, the formulas written out) against
``jax.vjp`` of the reference's oracle ``ssd_intra_chunk_ref`` (B and C
repeated over each group's heads, the group sums of dB and dC taken) and
against torch's autograd of the forward twin; and the train Function's
wiring (``_SsdIntraChunk``, with its two kernel calls replaced by the
plain forward and backward) under ``ssd_chunked``, held against
``jax.grad`` of the reference's ``ssd_chunked(use_kernel=False)`` at a T
that is no multiple of the chunk, with B and C views of one conv output.

Tolerance: the reference's SSD 2e-5 (tests/test_kernels.py), taken
relative to each gradient's largest |value| where that exceeds 1 (dcum
sums up to Q^2 terms a row); bf16 inputs at 2e-2 the same way. The CUDA
kernel is held against the same twin on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.kernels.ref import ssd_intra_chunk_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 2e-5                 # tests/test_kernels.py's SSD tolerance
TOL_BF16 = 2e-2
NAMES = ("dcum", "db", "dc", "dxdt")


def _close(got, want, tol, what):
    """Within ``tol``, relative to the largest |want| where that exceeds
    1."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


# (Bz, NC, Q, H, G, N, P, the log-decay's steepness): one group shared by
# 4 heads, 2 groups of 2, a group per head, ragged Q / N / P, N and P over
# one 64-wide tile, and log-decays steep enough that the -60 clip binds
CASES = {"G1-rep4": (2, 3, 32, 4, 1, 16, 8, 0.2),
         "G2-rep2": (1, 2, 32, 4, 2, 16, 8, 0.2),
         "GH-rep1": (1, 2, 32, 3, 3, 8, 8, 0.2),
         "ragged": (1, 2, 40, 4, 2, 12, 6, 0.2),
         "wide": (1, 1, 100, 2, 1, 70, 66, 0.2),
         "clip": (1, 2, 32, 2, 1, 16, 8, 5.0)}


def _case(name):
    """Numpy inputs and output gradients: cum a decreasing cumulative
    log-decay, the rest standard normal."""
    bz, nc, q, h, g, n, p, steep = CASES[name]
    rng = np.random.default_rng(sum(CASES[name][:7]))
    da = -(0.05 + steep * rng.random((bz, nc, q, h)))
    arrs = [np.cumsum(da, axis=2)]
    for shape in ((bz, nc, q, g, n), (bz, nc, q, g, n), (bz, nc, q, h, p),
                  (bz, nc, q, h, p), (bz, nc, h, p, n), (bz, nc, h)):
        arrs.append(rng.normal(size=shape))
    return [a.astype(np.float32) for a in arrs]


def _torch_args(arrs, dtype):
    """cum, b, c, xdt, dy, dstate, ddecay; b, c, xdt, dy in ``dtype``."""
    out = [_t(a) for a in arrs]
    for i in (1, 2, 3, 4):
        out[i] = out[i].to(dtype)
    return out


def _jax_grads(arrs, dtype):
    """jax.vjp of the reference's oracle on the flattened, repeated layout,
    brought back to the grouped layouts (dB and dC summed over each
    group's heads)."""
    cum, b, c, xdt, dy, dstate, ddecay = arrs
    bz, nc, q, h = cum.shape
    g, n, p = b.shape[3], b.shape[4], xdt.shape[4]
    rep = h // g
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def flat(cum, b, c, xdt):
        bh = jnp.repeat(b, rep, axis=3).transpose(0, 1, 3, 2, 4)
        ch = jnp.repeat(c, rep, axis=3).transpose(0, 1, 3, 2, 4)
        return ssd_intra_chunk_ref(
            cum.transpose(0, 1, 3, 2).reshape(-1, q), bh.reshape(-1, q, n),
            ch.reshape(-1, q, n),
            xdt.transpose(0, 1, 3, 2, 4).reshape(-1, q, p))

    _, vjp = jax.vjp(flat, jnp.asarray(cum), jnp.asarray(b, jdt),
                     jnp.asarray(c, jdt), jnp.asarray(xdt, jdt))
    grads = vjp((jnp.asarray(dy, jdt).transpose(0, 1, 3, 2, 4)
                 .reshape(-1, q, p),
                 jnp.asarray(dstate).transpose(0, 1, 2, 4, 3)
                 .reshape(-1, n, p),
                 jnp.asarray(ddecay).reshape(-1)))
    return [np.asarray(x, np.float32) for x in grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_twin_matches_jax_vjp_of_the_reference(case, dtype):
    arrs = _case(case)
    if dtype == torch.bfloat16:     # both sides see the same bf16 values
        for i in (1, 2, 3, 4):
            arrs[i] = _t(arrs[i]).to(dtype).float().numpy()
    got = sc.ssd_intra_chunk_grouped_bwd_plain(*_torch_args(arrs, dtype))
    want = _jax_grads(arrs, dtype)
    assert [x.dtype for x in got] == [torch.float32] + [dtype] * 3
    for name, a, w, ref in zip(NAMES, got, want, arrs):
        assert tuple(a.shape) == ref.shape, name
        _close(a.float().numpy(), w, TOL if dtype == torch.float32
               else TOL_BF16, f"{case} {name}")
    if case == "clip":
        cum = arrs[0]
        assert (cum[:, :, -1] - cum[:, :, 0] < -60.0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_twin_matches_autograd_of_the_forward_twin(case, dtype):
    args = _torch_args(_case(case), dtype)
    ins = [x.clone().requires_grad_() for x in args[:4]]
    want = torch.autograd.grad(sc.ssd_intra_chunk_grouped_plain(*ins), ins,
                               args[4:])
    got = sc.ssd_intra_chunk_grouped_bwd_plain(*args)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == w.dtype, name
        _close(a.float().numpy(), w.float().numpy(),
               TOL if dtype == torch.float32 else TOL_BF16,
               f"{case} {name}")


@pytest.mark.parametrize("bad,match", [
    (dict(dy=torch.zeros((1, 2, 8, 4, 5), dtype=torch.bfloat16)),
     "dy dtype"),
    (dict(dy=torch.zeros((1, 2, 8, 5, 4)).transpose(3, 4)), "contiguous"),
    (dict(dstate=torch.zeros((1, 2, 4, 2, 5))), "dstate shape"),
    (dict(ddecay=torch.zeros((1, 2, 4), dtype=torch.float64)),
     "ddecay dtype"),
    (dict(b=torch.zeros((1, 2, 8, 3, 2)), c=torch.zeros((1, 2, 8, 3, 2))),
     "do not divide")])
def test_bwd_refuses_what_the_kernel_does_not_take(bad, match):
    args = dict(cum=torch.zeros((1, 2, 8, 4)), b=torch.zeros((1, 2, 8, 2, 2)),
                c=torch.zeros((1, 2, 8, 2, 2)),
                xdt=torch.zeros((1, 2, 8, 4, 5)),
                dy=torch.zeros((1, 2, 8, 4, 5)),
                dstate=torch.zeros((1, 2, 4, 5, 2)),
                ddecay=torch.zeros((1, 2, 4)))
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        sc.ssd_intra_chunk_grouped_bwd_plain(**args)
    with pytest.raises((TypeError, ValueError), match=match):
        sc.ssd_intra_chunk_grouped_bwd_cuda(**args)


def test_bwd_cuda_wrapper_refuses_cpu_tensors():
    args = _torch_args(_case("G1-rep4"), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        sc.ssd_intra_chunk_grouped_bwd_cuda(*args)


# (dtype, offset of B in the conv output or None, N, P, whether every row
# the backward stages starts on 16 bytes)
STAGING_CASES = [
    (torch.float32, None, 32, 32, True),
    (torch.float32, 2048, 128, 64, True),      # mamba2-370m's views
    (torch.float32, 3, 40, 64, False),         # the card's "unaligned"
    (torch.float32, None, 40, 70, False),      # P = 70: a head's 280 bytes
    (torch.float32, None, 130, 72, False),     # N = 130: rows of 520 bytes
    (torch.bfloat16, None, 32, 32, True),
    (torch.bfloat16, 8, 64, 64, True),         # 16 bytes into the output
    (torch.bfloat16, 3, 40, 64, False),
    (torch.bfloat16, None, 64, 36, False)]     # P = 36: 72 bytes


@pytest.mark.parametrize("dtype,offset,n,p,aligned", STAGING_CASES)
def test_bwd_staging_variant(dtype, offset, n, p, aligned):
    """``_bwd_vec16``, the backward's staging variant as
    ``repro_ssd_grouped_bwd`` picks it from the pointers and strides:
    16-byte cp.async where every tile row of B, C, xdt, dy and dstate
    starts on 16 bytes, plain loads for views 3 elements into the conv
    output and for a P or N whose rows are no 16-byte multiple; the
    forward's ``_vec16`` agrees where dy and dstate add nothing."""
    args = sc.grouped_bwd_example(1, 2, 64, 4, 2, n, p, dtype=dtype,
                                  offset=offset)
    assert sc._bwd_vec16(*args[1:6]) == aligned
    if n % 4 == 0:
        assert sc._vec16(*args[1:4]) == aligned


@pytest.mark.parametrize("shape,want", [
    # mamba2-370m's train microbatch: Bz 2, NC 16, Q 256, H 32, G 1, N 128
    ((2, 16, 256, 32, 1, 128, 64),
     dict(heads_per_block=16, subsets=2, scores=320, state=256, pair=640,
          dxdt=4096, heads=4992, reduce=512)),
    # zamba2-7b's: Bz 1, NC 16, H 112, N 64
    ((1, 16, 256, 112, 1, 64, 64),
     dict(heads_per_block=16, subsets=7, scores=160, state=448, pair=1120,
          dxdt=7168, heads=8736, reduce=128)),
    # 112 heads over one 64-row tile: every key tile kt = 0
    ((1, 4, 64, 112, 1, 64, 64),
     dict(heads_per_block=16, subsets=7, scores=4, state=28, pair=28,
          dxdt=448, heads=504, reduce=8)),
    # two groups, ragged Q and N
    ((1, 2, 100, 8, 2, 40, 70),
     dict(heads_per_block=4, subsets=1, scores=12, state=8, pair=12,
          dxdt=32, heads=52, reduce=16))])
def test_bwd_blocks(shape, want):
    """The backward's head subset and its blocks per launch at both
    models' shapes: one dxdt block a head and key tile (no serial head
    loop), pair and state blocks over subsets of up to 16 heads."""
    assert sc.bwd_blocks(*shape) == want


@pytest.mark.parametrize("rep,hs", [(1, 1), (4, 4), (7, 7), (24, 12),
                                    (32, 16), (112, 16)])
def test_bwd_heads_per_block(rep, hs):
    """The largest divisor of the heads a group up to 16; the forward's
    subset stays at most 8."""
    assert sc.bwd_heads_per_block(rep) == hs
    assert sc.heads_per_block(rep) == max(
        d for d in range(1, min(rep, 8) + 1) if rep % d == 0)


@pytest.mark.parametrize("offset,steep", [(None, 0.2), (3, 1.0)])
def test_bwd_example_inputs_are_what_the_kernel_takes(offset, steep):
    """``grouped_bwd_example``, the draw the card's checks hold the kernel
    against its twin on: arguments ``check_grouped_bwd`` takes, B and C
    views of one conv-output-like tensor where ``offset`` is given, the
    same tensors for the same seed, and the -60 clip binding at steepness
    1.0 over a 256-row chunk (not at 0.2 over 32 rows)."""
    q = 256 if steep == 1.0 else 32

    def draw():
        return sc.grouped_bwd_example(1, 2, q, 4, 2, 8, 6, steep=steep,
                                      dtype=torch.bfloat16, seed=5,
                                      offset=offset)
    args = draw()
    sc.check_grouped_bwd(*args)
    cum, b, c = args[:3]
    assert [x.dtype for x in args[1:5]] == [torch.bfloat16] * 4
    if offset is not None:
        assert not b.is_contiguous()
        assert (b.untyped_storage().data_ptr()
                == c.untyped_storage().data_ptr())
    for x, y in zip(args, draw()):
        assert torch.equal(x, y)
    binds = bool((cum[:, :, -1] - cum[:, :, 0] < -60.0).any())
    assert binds == (steep == 1.0)


@pytest.fixture
def function_route(monkeypatch):
    """``ops`` routes as on the card, and the train Function's two kernel
    calls run the plain forward and backward (counted)."""
    calls = {"forward": 0, "backward": 0}

    def forward(*a):
        calls["forward"] += 1
        return sc.ssd_intra_chunk_grouped_plain(*a)

    def backward(*a):
        calls["backward"] += 1
        return sc.ssd_intra_chunk_grouped_bwd_plain(*a)

    monkeypatch.setattr(ops, "_route", lambda device, what: True)
    monkeypatch.setattr(sc, "ssd_intra_chunk_grouped_cuda", forward)
    monkeypatch.setattr(sc, "ssd_intra_chunk_grouped_bwd_cuda", backward)
    return calls


def _chunked_inputs(seed, bz, t, h, p, g, n, offset):
    """x, dt, a and the conv-output-like xbc (Bz, T, offset + 2 G N) whose
    slices are B and C."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bz, t, h, p))
    dt = 0.1 + 0.5 * rng.random((bz, t, h))
    a = -(0.5 + rng.random(h))
    xbc = rng.normal(size=(bz, t, offset + 2 * g * n))
    wy = rng.normal(size=(bz, t, h, p))
    ws = rng.normal(size=(bz, h, p, n))
    return [v.astype(np.float32) for v in (x, dt, a, xbc, wy, ws)]


def _split(xbc, offset, g, n):
    bz, t = xbc.shape[:2]
    return (xbc[..., offset:offset + g * n].reshape(bz, t, g, n),
            xbc[..., offset + g * n:].reshape(bz, t, g, n))


@pytest.mark.parametrize("route", ["twin", "function"])
@pytest.mark.parametrize("t,g", [(49, 1), (48, 2)])
@pytest.mark.parametrize("with_final_state", [False, True],
                         ids=["y", "y+final_state"])
def test_ssd_chunked_gradients_match_jax_grad(request, t, g, route,
                                              with_final_state):
    """Gradients of sum(y * wy) (+ sum(final_state * ws)) in x, dt, a and
    the conv output that B and C are views of, chunk 16: T = 49 pads the
    last chunk (cum flat over the pad), T = 48 hands B and C to the seam as
    views. ``route="function"`` goes through ``_SsdIntraChunk`` (one
    forward and one backward call), ``"twin"`` through torch's autograd of
    the CPU twin. Training drops the final state (the last chunk's dstate
    and ddecay then arrive as zeros); with it, they do not."""
    calls = (request.getfixturevalue("function_route") if route == "function"
             else None)
    h, p, n, offset = 4, 8, 16, 5
    jcfg = dataclasses.replace(j_get_reduced("mamba2-370m"), ssm_chunk=16)
    tcfg = dataclasses.replace(get_reduced("mamba2-370m"), ssm_chunk=16)
    x, dt, a, xbc, wy, ws = _chunked_inputs(t + g, 2, t, h, p, g, n, offset)

    def jloss(x, dt, a, xbc):
        B, C = _split(xbc, offset, g, n)
        y, s = jssm.ssd_chunked(x, dt, a, B, C, jcfg, use_kernel=False)
        out = jnp.sum(y * wy)
        return out + jnp.sum(s * ws) if with_final_state else out

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x, dt, a, xbc)))
    ins = [_t(v).requires_grad_() for v in (x, dt, a, xbc)]
    B, C = _split(ins[3], offset, g, n)
    y, s = tssm.ssd_chunked(ins[0], ins[1], ins[2], B, C, tcfg)
    loss = (y * _t(wy)).sum()
    if with_final_state:
        loss = loss + (s * _t(ws)).sum()
    got = torch.autograd.grad(loss, ins)
    if calls is not None:
        assert calls == {"forward": 1, "backward": 1}
    for name, gv, wv in zip(("x", "dt", "a", "xbc"), got, want):
        assert tuple(gv.shape) == np.shape(wv), name
        _close(gv.numpy(), np.asarray(wv), TOL, f"{route} T={t} {name}")


def test_views_reach_the_function_as_views(function_route, monkeypatch):
    """At a T that is a multiple of the chunk, the B and C the Function
    saves are views of the conv output, and the gradient it returns for
    them has their shape (autograd scatters it into the conv output's)."""
    seen = {}
    fwd = sc.ssd_intra_chunk_grouped_cuda

    def spy(cum, b, c, xdt):
        seen["b"] = b
        return fwd(cum, b, c, xdt)

    monkeypatch.setattr(sc, "ssd_intra_chunk_grouped_cuda", spy)
    tcfg = dataclasses.replace(get_reduced("mamba2-370m"), ssm_chunk=16)
    x, dt, a, xbc, wy, _ = _chunked_inputs(3, 2, 32, 4, 8, 1, 16, 5)
    xbc_t = _t(xbc).requires_grad_()
    B, C = _split(xbc_t, 5, 1, 16)
    y, _ = tssm.ssd_chunked(_t(x), _t(dt), _t(a), B, C, tcfg)
    (grad,) = torch.autograd.grad((y * _t(wy)).sum(), [xbc_t])
    assert not seen["b"].is_contiguous()
    assert seen["b"].untyped_storage().data_ptr() == \
        xbc_t.untyped_storage().data_ptr()
    assert grad.shape == xbc_t.shape
    assert function_route == {"forward": 1, "backward": 1}
    assert float(grad[..., :5].abs().max()) == 0.0   # x's part: unused


def test_reference_shaped_entry_trains_through_the_function(function_route):
    """``ops.ssd_intra_chunk`` under autograd goes through the same
    Function with H = G = 1: its gradients against ``jax.vjp`` of the
    reference's oracle."""
    arrs = _case("G1-rep4")
    cum, b, c, xdt, dy, dstate, ddecay = arrs
    bz, nc, q, h = cum.shape
    # the reference's (G, Q, .) layout: one cell per (batch, chunk, head)
    flat = [cum.transpose(0, 1, 3, 2).reshape(-1, q)] + [
        np.repeat(v, h, axis=3).transpose(0, 1, 3, 2, 4).reshape(
            -1, q, v.shape[4]) for v in (b, c)] + [
        xdt.transpose(0, 1, 3, 2, 4).reshape(-1, q, xdt.shape[4])]
    ins = [_t(v).requires_grad_() for v in flat]
    outs = ops.ssd_intra_chunk(*ins)
    cots = (dy.transpose(0, 1, 3, 2, 4).reshape(-1, q, dy.shape[4]),
            dstate.transpose(0, 1, 2, 4, 3).reshape(-1, dstate.shape[4],
                                                    dstate.shape[3]),
            ddecay.reshape(-1))
    got = torch.autograd.grad(outs, ins, [_t(v) for v in cots])
    assert function_route == {"forward": 1, "backward": 1}
    _, vjp = jax.vjp(ssd_intra_chunk_ref, *(jnp.asarray(v) for v in flat))
    want = vjp(tuple(jnp.asarray(v) for v in cots))
    for name, gv, wv in zip(NAMES, got, want):
        _close(gv.numpy(), np.asarray(wv), TOL, name)
