"""Port's LM training loop, CPU side, against the reference on the same
inputs: the optimizers and schedules; ``token_stream`` bit for bit; the
PAOTA train step (K = 3 clients, M = 2 local steps, a straggler, the
reference's noise replayed) over two rounds against the same round
composed from the reference's public pieces (its ``loss_fn`` under SGD,
``paota_aggregate_stacked``, the straggler merge), as
tests/test_train_step.py composes it (the reference's jitted step fails on
this tree), and its bf16 accumulation; the train CLI's demo. Inputs come
from fixed numpy seeds; tolerance is the reference's LM tolerance. The
card runs a reduced train step per attention family in
tests/test_torch_cuda.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.transformer as JT  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.core.aggregation import (  # noqa: E402
    paota_aggregate_stacked as j_aggregate)
from repro.data.synthetic import token_stream as j_token_stream  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
import repro_torch.core.aggregation as TA  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.synthetic import token_stream  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)     # the reference's LM tolerance


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **over):
    jcfg = dataclasses.replace(j_get_reduced(arch), **over)
    tcfg = dataclasses.replace(get_reduced(arch), **over)
    jp = jax.jit(lambda key: j_init_model(key, jcfg))(jax.random.PRNGKey(0))
    model = TT.params_from_jax(_np(jp), tcfg, device="cpu")
    return jcfg, jp, model


def _ref_value_and_grad(cfg):
    return jax.jit(lambda p, b: jax.value_and_grad(
        JT.loss_fn, has_aux=True)(p, b, cfg))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}


def _to_t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("make", [
    lambda o: o.sgd(0.1), lambda o: o.sgd(0.05, momentum=0.9),
    lambda o: o.adamw(0.01), lambda o: o.adamw(0.01, weight_decay=0.1),
    lambda o: o.sgd((JS if o is JO else TO).cosine(0.1, 2, 5)),
    lambda o: o.adamw((JS if o is JO else TO).wsd(0.1, 1, 2, 3))],
    ids=["sgd", "sgd-momentum", "adamw", "adamw-wd", "sgd-cosine",
         "adamw-wsd"])
def test_optimizers_match_reference(make):
    """Four steps of each optimizer on the same params and gradients, then
    apply_updates, global_norm and clip_by_global_norm."""
    jopt, topt = make(JO), make(TO)
    jp, tp = _tree(0), _to_t(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(4):
        g = _tree(10 + i)
        ju, js = jopt.update(g, js, jp)
        tu, ts = topt.update(_to_t(g), ts, tp)
        jp = JO.apply_updates(jp, ju)
        tp = TO.apply_updates(tp, tu)
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(float(TO.global_norm(tp)),
                               float(JO.global_norm(jp)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        got = TO.clip_by_global_norm(tp, max_norm)
        want = JO.clip_by_global_norm(jp, max_norm)
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_schedules_match_reference():
    for jf, tf in ((JS.constant(3e-4), TO.constant(3e-4)),
                   (JS.cosine(1e-3, 10, 100, 1e-5),
                    TO.cosine(1e-3, 10, 100, 1e-5)),
                   (JS.wsd(1e-2, 5, 20, 30), TO.wsd(1e-2, 5, 20, 30))):
        for s in (0, 1, 5, 9, 10, 11, 24, 25, 40, 54, 55, 99, 100, 150):
            want = float(jf(jnp.asarray(s, jnp.int32)))
            got = float(tf(torch.tensor(s, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_token_stream_is_the_reference_stream_bit_for_bit():
    for args in ((512, 4, 64, 3, 0), (49152, 2, 33, 2, 7), (7, 3, 10, 2, 1)):
        got = list(token_stream(*args))
        want = list(j_token_stream(*args))
        assert len(got) == len(want) == args[3]
        for g, w in zip(got, want):
            assert g["tokens"].dtype == w["tokens"].dtype == np.int32
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m",
                                  "zamba2-7b", "hubert-xlarge"])
def test_shapes_and_runtime_config_match_reference(arch):
    """``SHAPES``, ``shape_config`` and ``runtime_config`` against the
    reference's for every shape, field by field."""
    from repro.launch import shapes as JSH
    from repro.launch.steps import runtime_config as j_runtime_config
    from repro_torch.configs import get_config
    from repro_torch.launch import shapes as TSH
    from repro.configs import get_config as j_get_config
    assert list(TSH.SHAPES) == list(JSH.SHAPES)
    for name, shape in TSH.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JSH.SHAPES[name])
        for fn, jfn in ((TSH.shape_config, JSH.shape_config),
                        (steps.runtime_config, j_runtime_config)):
            got = fn(get_config(arch), shape)
            want = jfn(j_get_config(arch), JSH.SHAPES[name])
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


K, M, MB, T, LR, SIGMA = 3, 2, 2, 24, 0.05, 1e-4
POWERS = np.array([2.0, 3.0, 5.0], np.float32)
MASK = np.array([1.0, 0.0, 1.0], np.float32)        # client 1 straggles


def _ref_round(jcfg, stacked, toks, r, accum=1):
    """The reference's round from its public pieces: each client's M SGD
    steps on loss_fn (in ``accum`` chunks with a bf16 gradient sum, as its
    step does), paota_aggregate_stacked on the round's key, the straggler
    merge. Returns (new stacked, mean step loss, varsigma, the (d,) draw)."""
    vg = _ref_value_and_grad(jcfg)
    k = toks.shape[0]
    new, losses = [], []
    for c in range(k):
        p = jax.tree_util.tree_map(lambda x: x[c], stacked)
        for m in range(toks.shape[1]):
            mb = jnp.asarray(toks[c, m])
            if accum == 1:
                (l, _), g = vg(p, {"tokens": mb})
                p = jax.tree_util.tree_map(
                    lambda a, b: (a - LR * b.astype(jnp.float32)).astype(
                        a.dtype), p, g)
            else:
                g_sum = jax.tree_util.tree_map(
                    lambda x: jnp.zeros(x.shape, jnp.bfloat16), p)
                l = 0.0
                for chunk in mb.reshape((accum, -1) + mb.shape[1:]):
                    (l_i, _), g = vg(p, {"tokens": chunk})
                    g_sum = jax.tree_util.tree_map(
                        lambda a, b: a + b.astype(a.dtype), g_sum, g)
                    l = l + l_i
                p = jax.tree_util.tree_map(
                    lambda a, b: (a - (LR / accum) * b.astype(
                        jnp.float32)).astype(a.dtype), p, g_sum)
                l = l / accum
            losses.append(float(l))
        new.append(p)
    new = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *new)
    powers, mask = jnp.asarray(POWERS[:k]), jnp.asarray(MASK[:k])
    sigma = SIGMA * jnp.maximum(jnp.sum(powers * mask), 1e-12)
    key = jax.random.key_data(jax.random.PRNGKey(r)).astype(jnp.uint32)
    d = sum(int(np.prod(x.shape[1:]))
            for x in jax.tree_util.tree_leaves(new))
    draw = np.asarray(jax.random.normal(key, (d,), jnp.float32))
    agg, varsigma = j_aggregate(new, powers, mask, key, sigma)

    def merge(a, local):
        m = mask.reshape((k,) + (1,) * (local.ndim - 1)).astype(local.dtype)
        return m * jnp.broadcast_to(a[None], local.shape) + (1 - m) * local

    return (jax.tree_util.tree_map(merge, agg, new), float(np.mean(losses)),
            float(varsigma), draw)


def _stores(arch, k, scales):
    """The reference's stacked params (client c scaled by scales[c]) and
    the port's store holding the same values."""
    jcfg, jp, model = _pair(arch)
    jst = jax.tree_util.tree_map(
        lambda x: jnp.stack([x * s for s in scales]), jp)
    store = steps.stack_params(model, k)
    for leaf, want in zip(tree_leaves(store), jax.tree_util.tree_leaves(jst)):
        leaf.copy_(torch.from_numpy(np.array(want)))
    return jcfg, jst, model, store


def _check_store(store, jst):
    for got, (path, want) in zip(tree_leaves(store),
                                 jax.tree_util.tree_leaves_with_path(jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_step_matches_reference_round(monkeypatch):
    """K = 3, M = 2, client 1 straggling, the reference's AWGN draw
    replayed, two rounds: every leaf of the store, the loss and varsigma
    against the composed reference round; sweep 2 runs once per reference
    leaf a round; the straggler keeps its locally trained params."""
    jcfg, jst, model, store = _stores("smollm-135m", K, (1.0, 1.01, 0.99))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, K, M, MB, T)).astype(np.int32)
    draws = {}
    step = steps.make_paota_train_step(
        model, InputShape("t", T, K * MB, "train"), K, lr=LR, local_steps=M,
        sigma_over_varsigma=SIGMA,
        noise=lambda key, d, device: torch.from_numpy(draws[key].copy()))
    calls = []
    sweep2 = TA.superpose_normalize

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return sweep2(*args, **kw)

    monkeypatch.setattr(TA, "superpose_normalize", counting)
    n_leaves = len(jax.tree_util.tree_leaves(jst))
    assert n_leaves == len(steps.param_layout(model)) == 11
    for r in range(2):
        jst, loss, varsigma, draws[r] = _ref_round(jcfg, jst, toks[r], r)
        calls.clear()
        store, metrics = step(store, {"tokens": torch.from_numpy(toks[r])},
                              torch.from_numpy(POWERS),
                              torch.from_numpy(MASK), r)
        assert len(calls) == n_leaves
        _check_store(store, jst)
        np.testing.assert_allclose(float(metrics["loss"]), loss, **TOL)
        np.testing.assert_allclose(float(metrics["varsigma"]), varsigma,
                                   rtol=1e-6)
        assert float(metrics["participants"]) == 2.0
    # the straggler's row differs from the participants' aggregate
    emb = store["embedding"]["embed"]
    assert torch.equal(emb[0], emb[2]) and not torch.equal(emb[0], emb[1])


def test_train_step_bf16_accumulation_matches_reference(monkeypatch):
    """The accumulation branch: tokens per step past 2 x ACCUM_TOKENS (cut
    to 24 tokens here), so a client's microbatch of 4 runs in 2 chunks with
    a bf16 gradient sum, as the reference's step does; K = 2, one round."""
    monkeypatch.setattr(steps, "ACCUM_TOKENS", 48)
    jcfg, jst, model, store = _stores("olmo-1b", 2, (1.0, 1.02))
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 1, 4, T)).astype(np.int32)
    jst, loss, varsigma, draw = _ref_round(jcfg, jst, toks, 0, accum=2)
    step = steps.make_paota_train_step(
        model, InputShape("t", T, 8, "train"), 2, lr=LR, local_steps=1,
        sigma_over_varsigma=SIGMA,
        noise=lambda key, d, device: torch.from_numpy(draw))
    store, metrics = step(store, {"tokens": torch.from_numpy(toks)},
                          torch.from_numpy(POWERS[:2]),
                          torch.from_numpy(MASK[:2]), 0)
    _check_store(store, jst)
    np.testing.assert_allclose(float(metrics["loss"]), loss, **TOL)


def test_noiseless_step_skips_sweep_2(monkeypatch):
    """sigma_over_varsigma = 0: the noiseless contraction, no sweep 2 and
    no draw, as the reference skips both."""
    jcfg, _, model, store = _stores("smollm-135m", 2, (1.0, 1.0))
    monkeypatch.setattr(TA, "superpose_normalize", None)
    step = steps.make_paota_train_step(
        model, InputShape("t", T, 4, "train"), 2, lr=LR, local_steps=1,
        sigma_over_varsigma=0.0, noise=None)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 1, 2, T)).astype(np.int32)
    _, metrics = step(store, {"tokens": torch.from_numpy(toks)},
                      torch.ones(2), torch.ones(2), 0)
    assert np.isfinite(float(metrics["loss"]))


def test_train_cli_demo_on_cpu(tmp_path, capsys):
    """The train CLI's demo on the CPU: K = 2 clients, the loss finite and
    falling over three rounds, a checkpoint in the reference's npz layout
    whose leaves are the store's (K, ...) leaves in leaf order."""
    from repro.checkpoint.io import load_checkpoint as j_load
    path = tmp_path / "ck.npz"
    train_cli.main(["--demo", "--device", "cpu", "--rounds", "3",
                    "--local-steps", "2", "--clients", "2",
                    "--checkpoint", str(path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round ")]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    cfg = dataclasses.replace(j_get_reduced("smollm-135m"), remat="block")
    template = jax.tree_util.tree_map(
        lambda x: jnp.zeros((2,) + x.shape, x.dtype),
        j_init_model(jax.random.PRNGKey(0), cfg))
    restored = j_load(str(path), template)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(restored))
