"""The port's pytree carry and bf16 carry, held against the reference.

Pytree: the tree reductions of ``core.power_control``, the per-leaf noise
split and superposition of ``core.aggregation``, the per-leaf route of
``kernels.ops.round_stats``, and ``FusedPAOTA(params_mode="pytree")``
against the reference's pytree FusedPAOTA (dense and cohort, both transmit
modes, on the reference's draws) and against the port's raveled run
(tests/test_pytree_round.py).

bf16 carry: the cast planes bit-equal to the reference's on equal f32
rows, both sweeps on bf16 planes against the reference's at the bf16
kernel tolerance, the deltas formed in f32 before the cast, and the port's
bf16 run within the reference's bf16 envelope of the reference's bf16 run
(tests/test_round_stats.py:218). K = 8, make_mnist_like(n_train=2000),
the 784-10-10-10 MLP; every input from a fixed seed."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import power_control as tpc  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_cohort import port, reference, reference_draws  # noqa: E402

K = 8
R = 10
# the fused tolerance (ROADMAP Queue 3; tests/test_torch_fused.py TOL)
TOL = {"model": dict(rtol=1e-4, atol=1e-5, varsigma=1e-5),
       "delta": dict(rtol=1e-4, atol=5e-5, varsigma=5e-4)}
MLP = {"l1": {"w": (784, 10), "b": (10,)}, "l2": {"w": (10, 10), "b": (10,)},
       "l3": {"w": (10, 10), "b": (10,)}}


@pytest.fixture(scope="module")
def data():
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    return x, y, partition_noniid(y, n_clients=K, seed=0)


def _mlp_tree(seed, lead=(), dtype=np.float32):
    """An MLP-shaped dict of numpy leaves with a leading ``lead`` shape."""
    rng = np.random.default_rng(seed)
    return {layer: {name: rng.standard_normal(lead + shape).astype(dtype)
                    for name, shape in leaves.items()}
            for layer, leaves in MLP.items()}


def _torch(tree):
    return tree_map(torch.from_numpy, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rows(tree):
    """(K, d) raveled rows of a stacked numpy tree, in leaf order."""
    leaves = jax.tree_util.tree_leaves(tree)
    return np.concatenate([l.reshape(l.shape[0], -1) for l in leaves], 1)


# ---------------------------------------------------------------------------
# tree units
# ---------------------------------------------------------------------------

def test_tree_scalars_match_reference():
    """client_sq_norms / client_dots / global_sq_norm / cosine_similarity
    on the stacked MLP tree against the reference's on the same tree, and
    against the port's own raveled form (tests/test_pytree_round.py:78)."""
    from repro.core import power_control as rpc
    stacked, vec = _mlp_tree(0, (6,)), _mlp_tree(1)
    tol = dict(rtol=1e-5, atol=1e-6)
    flat, gflat = torch.from_numpy(_rows(stacked)), ravel_pytree(vec)[0]
    gflat = torch.from_numpy(np.array(gflat))
    pairs = [(tpc.client_sq_norms(_torch(stacked)),
              rpc.client_sq_norms(_jnp(stacked)), tpc.client_sq_norms(flat)),
             (tpc.client_dots(_torch(stacked), _torch(vec)),
              rpc.client_dots(_jnp(stacked), _jnp(vec)),
              tpc.client_dots(flat, gflat)),
             (tpc.global_sq_norm(_torch(vec)), rpc.global_sq_norm(_jnp(vec)),
              tpc.global_sq_norm(gflat)),
             (tpc.cosine_similarity(_torch(stacked), _torch(vec)),
              rpc.cosine_similarity(_jnp(stacked), _jnp(vec)),
              tpc.cosine_similarity(flat, gflat))]
    for got, want, raveled in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
        np.testing.assert_allclose(got.numpy(), raveled.numpy(), **tol)


@pytest.mark.parametrize("sigma", [0.3, 0.0], ids=["noisy", "noiseless"])
def test_stacked_tree_noise_is_leaf_split_invariant(sigma):
    """One flat AWGN realization split across the leaves: the tree
    aggregate equals the raveled one and the reference's tree aggregate on
    the same realization (``noise=None`` is the noiseless channel, the
    reference's sigma_n = 0 einsum path, which the fused round takes on a
    zero-bandwidth channel)."""
    from repro.core.aggregation import paota_aggregate_stacked
    stacked = _mlp_tree(2, (5,))
    powers = np.asarray([1.0, 0.5, 2.0, 0.0, 3.0], np.float32)
    mask = np.asarray([1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
    key = jax.random.PRNGKey(11)
    d = _rows(stacked).shape[1]
    flat_noise = np.asarray(sigma * jax.random.normal(key, (d,),
                                                      jnp.float32))
    noise = None if sigma == 0.0 else torch.from_numpy(flat_noise)
    p, m = torch.from_numpy(powers), torch.from_numpy(mask)
    agg_t, vs_t = tagg.paota_aggregate_stacked(_torch(stacked), p, m, noise)
    agg_f, vs_f = tagg.paota_aggregate_stacked(
        torch.from_numpy(_rows(stacked)), p, m, noise)
    want, vs_r = paota_aggregate_stacked(_jnp(stacked), jnp.asarray(powers),
                                         jnp.asarray(mask), key, sigma)
    got = tagg.ravel(agg_t)[0].numpy()
    np.testing.assert_allclose(got, agg_f.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(ravel_pytree(want)[0]),
                               rtol=1e-5, atol=1e-6)
    assert float(vs_t) == pytest.approx(float(vs_r), rel=1e-6)
    assert float(vs_t) == pytest.approx(float(vs_f), rel=1e-6)
    sizes = [l[0].numel() for l in tree_leaves(_torch(stacked))]
    parts = tagg.stacked_tree_noise(torch.from_numpy(flat_noise),
                                    tree_leaves(_torch(stacked)))
    assert [p.numel() for p in parts] == sizes
    np.testing.assert_array_equal(
        torch.cat([p.reshape(-1) for p in parts]).numpy(), flat_noise)


@pytest.mark.parametrize("payload", [False, True], ids=["deltas", "payload"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_stats_per_leaf_matches_reference(dtype, payload):
    """ops.round_stats on the stacked MLP tree (one sweep per leaf, stats
    summed in leaf order) against the reference's round_stats_jnp."""
    from repro.kernels.round_stats import round_stats_jnp
    jdt = jnp.dtype(dtype)
    deltas = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                    _mlp_tree(3, (K,)))
    pay = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                  _mlp_tree(4, (K,))) if payload else None)
    g = _jnp(_mlp_tree(5))

    def to_port(tree):
        return tree_map(lambda a: _bf16_or_f32(np.asarray(a)), tree)

    got = tops.round_stats(to_port(deltas), to_port(g),
                           None if pay is None else to_port(pay))
    want = round_stats_jnp(deltas, g, pay)
    for x, w in zip(got, want):
        if w is None:
            assert x is None
            continue
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=3e-5,
                                   atol=3e-5)


def _bf16_or_f32(a: np.ndarray) -> torch.Tensor:
    """A numpy (ml_dtypes bf16 or f32) array as a torch tensor, same bits."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# FusedPAOTA(params_mode="pytree")
# ---------------------------------------------------------------------------

def _pair(data, transmit, rounds=R, **kw):
    ref = reference(data, transmit, k=K, **kw)
    return ref, port(data, transmit, reference_draws(ref, rounds), k=K,
                     **kw)


def _track(ref, prt, transmit, rounds):
    tol = TOL[transmit]
    for a, b in zip(ref.advance(rounds), prt.advance(rounds)):
        assert b["n_participants"] == a["n_participants"]
        assert b["time"] == a["time"]
        assert b["varsigma"] == pytest.approx(a["varsigma"],
                                              rel=tol["varsigma"])
    np.testing.assert_allclose(prt.global_vec, ref.global_vec,
                               rtol=tol["rtol"], atol=tol["atol"])


@pytest.mark.parametrize("cohort", [0, 4], ids=["dense", "cohort"])
@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_pytree_fused_tracks_reference(data, transmit, cohort):
    """The port's pytree round against the reference's pytree round on the
    reference's draws, R rounds: its carry holds one contiguous tensor per
    leaf, and the globals stay at the fused tolerance."""
    kw = dict(params_mode="pytree", cohort_size=cohort or None)
    ref, prt = _pair(data, transmit, **kw)
    _track(ref, prt, transmit, 5)
    _track(ref, prt, transmit, R - 5)
    leaves = tree_leaves(prt._carry.deltas)
    assert len(leaves) == 6
    assert all(l.is_contiguous() and l.dtype == torch.float32
               for l in leaves)
    assert isinstance(prt.global_params(), dict)


@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_pytree_matches_raveled_over_rounds(data, transmit):
    """The port's pytree run against its raveled run on the same counter
    draws (tests/test_pytree_round.py:125): the reduction order across
    leaves is the only difference."""
    rav = port(data, transmit, k=K)
    tre = port(data, transmit, k=K, params_mode="pytree")
    for rf, rt in zip(rav.advance(6), tre.advance(6)):
        assert rf["n_participants"] == rt["n_participants"]
        assert rf["time"] == rt["time"]
        assert rf["varsigma"] == pytest.approx(rt["varsigma"], rel=1e-5)
        np.testing.assert_allclose(rav.global_vec, tre.global_vec,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["raveled", "pytree"])
@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_noiseless_channel_tracks_reference_without_sweep_2(
        data, transmit, mode, monkeypatch):
    """A noiseless channel (zero bandwidth, so sigma_n = 0): the reference
    skips the AWGN draw and contracts b*p with each leaf; the port takes
    the same plain contraction, sweep 2 never runs, and its globals track
    the reference's at the fused tolerance."""
    def sweep_2(*args, **kwargs):
        raise AssertionError("sweep 2 ran on a noiseless channel")
    monkeypatch.setattr(tagg, "superpose_normalize", sweep_2)
    ref, prt = _pair(data, transmit, params_mode=mode,
                     chan=dict(bandwidth_hz=0.0))
    _track(ref, prt, transmit, R)


def test_pytree_zero_uploaders_hold_global_bit_for_bit(data):
    import repro_torch.core as tcore
    import repro_torch.fl as tfl
    from repro_torch.data.pipeline import build_federation
    from repro_torch.models.mlp import init_mlp_params, mlp_loss
    x, y, parts = data
    clients = [tfl.FLClient(d, mlp_loss, batch_size=32, lr=0.1,
                            local_steps=5)
               for d in build_federation(x, y, parts)]
    drv = tfl.FusedPAOTA(init_mlp_params(0), clients, tcore.ChannelConfig(),
                         tcore.SchedulerConfig(n_clients=K, seed=1,
                                               delta_t=8.0, lat_lo=30.0,
                                               lat_hi=40.0),
                         tfl.PAOTAConfig(), device="cpu",
                         params_mode="pytree")
    g0 = {k: v.clone() for k, v in
          zip(range(6), tree_leaves(drv.global_params()))}
    rows = drv.advance(3)
    assert all(r["n_participants"] == 0 for r in rows)
    for i, leaf in enumerate(tree_leaves(drv.global_params())):
        assert torch.equal(leaf, g0[i])


# ---------------------------------------------------------------------------
# bf16 carry
# ---------------------------------------------------------------------------

def test_bf16_stage_parity_on_equal_inputs():
    """On equal f32 rows the port's bf16 planes are the reference's bit for
    bit (both round to nearest even), and both sweeps on them agree with
    the reference's at the bf16 kernel tolerance
    (tests/test_kernels.py:16)."""
    from repro.kernels.ops import superpose_normalize
    from repro.kernels.round_stats import round_stats_jnp
    rng = np.random.default_rng(7)
    rows = (rng.standard_normal((K, 8070)) * 0.05).astype(np.float32)
    rows[0, :5] = [1.0 + 2.0 ** -9, -(1.0 + 3 * 2.0 ** -9), 3e-39, 0.0,
                   65504.5]                     # ties, a subnormal, zero
    ref_bf = jnp.asarray(rows).astype(jnp.bfloat16)
    port_bf = torch.from_numpy(rows).to(torch.bfloat16)
    np.testing.assert_array_equal(
        port_bf.view(torch.int16).numpy(),
        np.asarray(ref_bf).view(np.int16))
    g = rng.standard_normal(8070).astype(np.float32)
    got = tops.round_stats(port_bf, torch.from_numpy(g), port_bf)
    want = round_stats_jnp(ref_bf, jnp.asarray(g), ref_bf)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=2e-2,
                                   atol=2e-2)
    powers = rng.uniform(0, 15, K).astype(np.float32)
    mask = (rng.random(K) < 0.6).astype(np.float32)
    noise = (1e-3 * rng.standard_normal(8070)).astype(np.float32)
    agg, raw = tops.superpose_normalize(port_bf, torch.from_numpy(powers),
                                        torch.from_numpy(mask),
                                        torch.from_numpy(noise))
    w_agg, w_raw = superpose_normalize(ref_bf, jnp.asarray(powers),
                                       jnp.asarray(mask), jnp.asarray(noise))
    np.testing.assert_allclose(agg.numpy(), np.asarray(w_agg), rtol=2e-2,
                               atol=2e-2)
    assert float(raw) == pytest.approx(float(w_raw), rel=1e-6)


@pytest.mark.parametrize("mode", ["raveled", "pytree"])
def test_bf16_deltas_formed_in_f32_before_the_cast(mode):
    """A delta of 2^-10 on a weight of 1000 survives the bf16 carry: it is
    formed in f32 (trained - w_g) and then rounded, never taken between
    two rounded models (bf16(1000 + 2^-10) - 1000 is 0), at round 0 and
    when a round refreshes the rows."""
    big = torch.full((3, 4), 1000.0)
    vec = {"a": {"w": big}} if mode == "pytree" else big.reshape(-1)
    step = 2.0 ** -10

    def train(g, r):
        return tree_map(lambda t: (t + step * (r + 1))[None].repeat(
            (2,) + (1,) * t.dim()), g)

    streams = trt.RoundStreams(local_train=train, latencies=None,
                               channel=None, noise=None)
    rcfg = trt.RoundCfg(omega=3.0, c1=1.0, c0=1.0, p_max_watts=1.0,
                        delta_t=1.0, transmit_delta=False,
                        pending_dtype="bfloat16")
    streams = streams._replace(latencies=lambda r: torch.ones(2))
    carry = trt.init_round_carry(vec, streams=streams, rcfg=rcfg)
    for leaf in tree_leaves(carry.deltas):
        assert leaf.dtype == torch.bfloat16
        assert torch.all(leaf.float() == step)
    for leaf in tree_leaves(carry.pending):
        assert torch.all(leaf.float() - 1000.0 == 0.0)     # rounded away
    take = torch.tensor([True, False])
    pending, deltas = trt._refresh_rows(carry, take, train(vec, 1), vec)
    for leaf in tree_leaves(deltas):
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(leaf[0].float().numpy(), 2 * step)
        np.testing.assert_array_equal(leaf[1].float().numpy(), step)


@pytest.mark.parametrize("mode", ["raveled", "pytree"])
@pytest.mark.parametrize("transmit", ["model", "delta"])
def test_bf16_run_tracks_reference_within_its_envelope(data, transmit,
                                                       mode):
    """pending_dtype='bfloat16': after the first aggregation and after 6
    rounds, the port's global sits within the reference's bf16 envelope
    (0.02 max|w_g|, tests/test_round_stats.py:218) of the reference's bf16
    run on the same draws; the participation is equal, the planes are
    bf16 and the globals f32."""
    kw = dict(pending_dtype="bfloat16", params_mode=mode)
    ref, prt = _pair(data, transmit, rounds=6, **kw)
    for n in (2, 4):
        for a, b in zip(ref.advance(n), prt.advance(n)):
            assert b["n_participants"] == a["n_participants"]
            assert b["time"] == a["time"]
        gap = float(np.max(np.abs(prt.global_vec - ref.global_vec)))
        assert gap < 0.02 * float(np.max(np.abs(ref.global_vec)))
    planes = [prt._carry.deltas] + (
        [prt._carry.pending] if transmit == "model" else [])
    assert all(l.dtype == torch.bfloat16 for p in planes
               for l in tree_leaves(p))
    assert all(l.dtype == torch.float32
               for l in tree_leaves(prt._carry.global_vec))
    assert np.isfinite(prt.global_vec).all()


def test_cli_runs_the_pytree_bf16_carry_on_cpu(capsys, tmp_path):
    """The paper driver with --engine fused --params-mode pytree
    --pending-dtype bfloat16, at K = 4 for 3 rounds; the knobs are refused
    without --engine fused."""
    from repro_torch.launch import fl_train
    fl_train.main(["--rounds", "3", "--clients", "4", "--device", "cpu",
                   "--engine", "fused", "--params-mode", "pytree",
                   "--pending-dtype", "bfloat16",
                   "--out", str(tmp_path / "fl.csv")])
    out = capsys.readouterr().out
    assert "engine=fused, transmit=model, params=pytree, pending=bfloat16" \
        in out
    assert "=== paota === final acc" in out
    with pytest.raises(ValueError, match="--engine fused"):
        fl_train.main(["--rounds", "1", "--clients", "4", "--device", "cpu",
                       "--params-mode", "pytree"])
