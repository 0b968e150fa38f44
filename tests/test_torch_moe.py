"""Port's moe family (mixtral-8x22b: 8 experts top-2, a 4,096-token window;
llama4-maverick-400b-a17b: 128 experts top-1, full attention), CPU side,
on the reduced configs (4 experts; mixtral's window 64) and reduced
mixtral with 6 query heads over 1 kv head (a GQA group of 6, as the full
model's 48 over 8): the router's top-k against ``lax.top_k`` (exact ties
too), ``apply_moe``'s routing (chosen experts, keep mask, queue places)
bit-equal to the reference's at the published capacity (with drops),
dropless and with pad rows; the forward's logits, caches and aux at
T = 40 and 150 (past the window); the prefill -> decode hand-off (rings,
f32 and int8 with f16 scales, bit-equal, with and without a wrap);
teacher-forced decode at the published capacity, where two tokens a step
get one slot per expert; continuity at a dropless capacity; one
attention call per layer per prefill; ``params_from_jax``; the full
configs and their param counts; the serve CLI. Inputs come from fixed
numpy seeds; tolerance is the reference's LM tolerance. A reduced
mixtral runs on the card in tests/test_torch_cuda.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.launch.steps import abstract_params  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.layers import apply_dense as j_apply_dense  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    active_param_count as j_active_param_count)
from repro.models.transformer import (  # noqa: E402
    cache_from_prefill as j_cache_from_prefill)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch.steps import prefill, serve  # noqa: E402
from repro_torch.models import (active_param_count,  # noqa: E402
                                decode_step, forward, init_model,
                                param_count)
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    AttentionBlock, LanguageModel, cache_from_prefill, params_from_jax)

# the reference's LM tolerance (tests/test_fused_round.py:57)
TOL = dict(rtol=1e-4, atol=1e-5)
B, T_DEC, RING = 2, 6, 80
MIXTRAL, LLAMA4 = "mixtral-8x22b", "llama4-maverick-400b-a17b"
ARCHS = (MIXTRAL, LLAMA4)
# (arch, overrides): the two reduced configs, and mixtral with a GQA group
# of 6 (the reduced mixtral has 4 query heads over 1)
VARIANTS = ((MIXTRAL, {}), (MIXTRAL, dict(num_heads=6, num_kv_heads=1)),
            (LLAMA4, {}))
IDS = ("mixtral", "mixtral-gqa6", "llama4")
# the published param counts: (total, active with k of E experts)
FULL_PARAMS = {MIXTRAL: (140_630_071_296, 39_161_468_928),
               LLAMA4: (778_214_937_600, 11_160_622_080)}

variants = pytest.mark.parametrize("arch,over", VARIANTS, ids=IDS)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **over):
    return (dataclasses.replace(j_get_reduced(arch), **over),
            dataclasses.replace(get_reduced(arch), **over))


def _pair(arch, **over):
    jcfg, tcfg = _cfgs(arch, **over)
    jp = j_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), tcfg, device="cpu")


def _tokens(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               err_msg=what, **(tol or TOL))


def _equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _meta_model(jcfg, tcfg) -> LanguageModel:
    """The port's module over the reference's abstract params, as meta
    tensors (no memory): the full configs' counts without an init."""
    tree = abstract_params(jcfg)

    def conv(node, layer=None):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v, layer) for k, v in node.items()}
        shape = node.shape if layer is None else node.shape[1:]
        return torch.empty(shape, device="meta")

    params = {"embedding": conv(tree["embedding"]),
              "layers": [conv(tree["layers"], i)
                         for i in range(tcfg.num_layers)],
              "final_norm": conv(tree["final_norm"])}
    return LanguageModel(tcfg, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference_and_counts_params(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert tcfg.family == "moe" and tcfg.moe_layer_period == 1
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(j_get_reduced(arch)) == \
        dataclasses.asdict(get_reduced(arch))
    abstract = abstract_params(jcfg)
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(abstract))
    active = j_active_param_count(abstract, jcfg)
    model = _meta_model(jcfg, tcfg)
    assert (param_count(model), active_param_count(model, tcfg)) == \
        (n, active) == FULL_PARAMS[arch]


def _router_logits(e, seed):
    """(2, 9, E) logits: normal rows, zero rows (uniform probs: exact ties
    everywhere) and rows whose top two or three values repeat."""
    rng = np.random.default_rng(seed)
    lg = rng.normal(size=(2, 9, e)).astype(np.float32)
    lg[0, 2] = 0.0
    lg[1, 5] = 0.0
    top = lg[0, 4].argmax()
    lg[0, 4, (top + 1) % e] = lg[0, 4, top]        # a tie at the top
    lg[1, 1, 1] = lg[1, 1, 3] = lg[1, 1].max() + 1.0
    lg[1, 7, :3] = lg[1, 7].max() + 0.5              # three-way tie
    return lg


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_lax_top_k_with_ties(arch):
    """mixtral's top-2 and llama4's top-1 over 4 experts: the selected
    experts bit-equal to ``lax.top_k``'s (descending, ties to the lower
    index), the weights and the aux loss at TOL; zero rows pick 0..k-1."""
    jcfg, tcfg = _cfgs(arch)
    k, e = tcfg.experts_per_token, tcfg.num_experts
    lg = _router_logits(e, seed=k)
    jw, jaux = JMOE.router_topk(jnp.asarray(lg), jcfg)
    tw, taux = MOE.router_topk(_t(lg), tcfg)
    _close(tw, jw, "weights")
    _close(taux, jaux, "aux")
    _equal(tw.numpy() > 0, np.asarray(jw) > 0, "selected experts")
    probs = torch.softmax(_t(lg), dim=-1)
    _, topi = MOE._top_k(probs, k)
    _, jtopi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(lg), axis=-1), k)
    _equal(topi.numpy(), np.asarray(jtopi), "top-k order")
    for row in ((0, 2), (1, 5)):
        assert topi[row].tolist() == list(range(k))


def _ref_route(jparams, xg, jcfg, cap):
    """The reference's routing lines of apply_moe (repro/models/moe.py
    :87-93) on token groups xg: (weights, keep, pos, chosen)."""
    logits = j_apply_dense(jparams["router"], xg)
    weights, aux = JMOE.router_topk(logits, jcfg)
    chosen = (weights > 0).astype(jnp.int32)
    pos = jnp.cumsum(chosen, axis=1) * chosen - 1
    keep = chosen * (pos < cap)
    return weights * keep, keep, pos, chosen


# (capacity_factor, moe_group_size, tokens per row): the published
# capacity (drops), a dropless one, and groups of 16 over 2 x 37 tokens
# (5 groups, the last with 6 zero pad rows)
MOE_CASES = ((1.25, 2048, 40), (8.0, 2048, 40), (1.25, 16, 37))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,group,t", MOE_CASES,
                         ids=("cf1.25", "cf8", "group16-pad6"))
def test_apply_moe_matches_reference(arch, cf, group, t):
    """The output and the aux loss at TOL; the routing bit-equal: the
    chosen experts, each token's place in each expert's queue and the keep
    mask. The inputs share one offset direction, so the router favours
    some experts and the published capacity drops tokens (asserted); at
    capacity 8 nothing drops; pad rows pick experts 0..k-1."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf, moe_group_size=group)
    jp = JMOE.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: (_t(np.asarray(v)) if not isinstance(v, dict)
              else {"w": _t(np.asarray(v["w"]))}) for k, v in jp.items()}
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(B, t, tcfg.d_model))
         + 4.0 * rng.normal(size=tcfg.d_model)).astype(np.float32)
    jout, jaux = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    tout, taux = MOE.apply_moe(tp, _t(x), tcfg)
    _close(tout, jout, "out")
    _close(taux, jaux, "aux")

    n_tok = B * t
    g = min(group, n_tok)
    pad = (-n_tok) % g
    assert pad == (6 if group == 16 else 0)
    xg = np.concatenate([x.reshape(n_tok, -1),
                         np.zeros((pad, tcfg.d_model), np.float32)])
    xg = xg.reshape(-1, g, tcfg.d_model)
    cap = MOE._group_capacity(g, tcfg)
    assert cap == JMOE._group_capacity(g, jcfg)
    jw, jkeep, jpos, jchosen = _ref_route(jp, jnp.asarray(xg), jcfg, cap)
    tw, tkeep, tpos, topi, _ = MOE.route(tp, _t(xg), tcfg, cap)
    _equal(tpos.numpy() >= 0, np.asarray(jchosen).astype(bool), "chosen")
    _equal(tpos.numpy(), np.asarray(jpos), "queue places")
    _equal(tkeep.numpy(), np.asarray(jkeep), "keep")
    _close(tw, jw, "kept weights")
    dropped = int((np.asarray(jchosen) - np.asarray(jkeep)).sum())
    if cf == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0, "the published capacity dropped no token"
    if pad:
        k = tcfg.experts_per_token
        assert topi[-1, g - pad:].tolist() == [list(range(k))] * pad


@variants
def test_init_model_tree_matches_abstract_params(arch, over):
    """The port's init: every leaf of the reference's tree (layers
    unstacked; the MoE layer's router and (E, d, ff) experts in place of
    the MLP), with its shape and dtype, and nothing else; the active count
    as the reference's."""
    jcfg, tcfg = _cfgs(arch, **over)
    model = init_model(tcfg, seed=0, device="cpu")
    sd = model.state_dict()
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            abstract_params(jcfg)):
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(tcfg.num_layers):
                want[f"layers.{i}.{'.'.join(keys[1:])}"] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert all(v.dtype == torch.float32 for v in sd.values())
    e, d, ff = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert want["layers.0.moe.gate"] == (e, d, ff)
    assert want["layers.0.moe.down"] == (e, ff, d)
    assert all(isinstance(b, AttentionBlock) and b.mlp is None
               for b in model.layers)
    jp = j_init_model(jax.random.PRNGKey(0), jcfg)
    assert active_param_count(model, tcfg) == j_active_param_count(jp, jcfg)
    assert param_count(model) == sum(int(np.prod(s)) for s in want.values())


@variants
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(arch, over, dtype):
    """Every leaf bit for bit, the stacked (L, E, d, ff) experts and the
    router among them."""
    jcfg, tcfg, jp, model = _pair(arch, param_dtype=dtype, **over)
    sd = model.state_dict()
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        leaf = np.asarray(leaf)
        if keys[0] == "layers":
            names = [f"layers.{i}.{'.'.join(keys[1:])}"
                     for i in range(tcfg.num_layers)]
            got = torch.stack([sd[k] for k in names])
        else:
            names = [".".join(keys)]
            got = sd[names[0]]
        seen.update(names)
        assert tuple(got.shape) == leaf.shape, names[0]
        want = (leaf.view(np.uint16) if leaf.dtype.name == "bfloat16"
                else leaf)
        have = (got.view(torch.int16).numpy().view(np.uint16)
                if got.dtype == torch.bfloat16 else got.numpy())
        np.testing.assert_array_equal(have, want, err_msg=names[0])
    assert seen == set(sd)
    assert {"layers.0.moe.router.w", "layers.0.moe.gate",
            "layers.0.moe.up", "layers.0.moe.down"} <= seen


def _ref_forward(jcfg, jp, toks):
    return j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                     return_cache=True)


@variants
@pytest.mark.parametrize("t", [40, 150])
def test_forward_logits_caches_and_aux_match_reference(arch, over, t):
    """At the published capacity. T = 150 is past reduced mixtral's
    64-token window (the reference's masked einsum, the port's
    ops.swa_attention with window 64); llama4 takes the whole causal
    triangle. aux is the layers' mean load-balance loss."""
    jcfg, tcfg, jp, model = _pair(arch, **over)
    assert tcfg.sliding_window == (64 if arch == MIXTRAL else None)
    toks = _tokens(tcfg, t, seed=t)
    jlog, jaux, jc = _ref_forward(jcfg, jp, toks)
    with torch.inference_mode():
        tlog, aux, tc = forward(model, {"tokens": _t(toks)},
                                return_cache=True)
    _close(tlog, jlog, f"logits T={t}")
    _close(aux, jaux, f"aux T={t}")
    assert float(aux) > 0.0
    assert set(tc) == set(jc) == {"k", "v"}
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == (tcfg.num_layers, B, t,
                                      tcfg.num_kv_heads, tcfg.head_dim)
        _close(tc[k], jc[k], f"cache {k} T={t}")


@variants
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("t_pre", [11, 100])
def test_cache_from_prefill_rings_bit_equal(arch, over, kv_quant, t_pre):
    """The reference's own prefill caches through both hand-offs into an
    80-token cache: mixtral's ring has 64 slots (its window), llama4's 80;
    100 positions wrap both. Under kv_quant the int8 payloads and the f16
    scales are bit-equal."""
    jcfg, tcfg, jp, _ = _pair(arch, kv_quant=kv_quant, **over)
    _, _, jc = _ref_forward(jcfg, jp, _tokens(tcfg, t_pre, seed=t_pre))
    tc = {k: _t(np.asarray(v)) for k, v in jc.items()}
    jst = j_cache_from_prefill(jc, jcfg, B, RING, t_pre)
    tst = cache_from_prefill(tc, tcfg, B, RING, t_pre)
    names = {"k", "v"} | ({"k_scale", "v_scale"} if kv_quant else set())
    assert set(tst) == set(jst) == names
    slots = 64 if arch == MIXTRAL else RING
    for k in names:
        assert tst[k].shape[:3] == (tcfg.num_layers, B, slots)
        assert str(tst[k].dtype).split(".")[-1] == np.asarray(
            jst[k]).dtype.name
        _equal(tst[k].numpy(), jst[k], f"ring {k}")
    if kv_quant:
        assert tst["k"].dtype == torch.int8
        assert tst["k_scale"].dtype == torch.float16


@variants
@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_steps_match_reference(arch, over, kv_quant, monkeypatch):
    """Teacher-forced at the published capacity: two tokens a step make
    one group of g = 2 with one slot per expert (cap = 1), so when both
    pick an expert the second loses its share there, as in the reference
    (a drop happens in this run: asserted). The reference's caches of an
    11-token prompt handed off by each package, then 6 decode steps, each
    step's logits and rings against the reference's (f32 rings at TOL,
    int8 payloads and f16 scales bit-equal)."""
    jcfg, tcfg, jp, model = _pair(arch, kv_quant=kv_quant, **over)
    assert MOE._group_capacity(B, tcfg) == 1
    drops = []

    def counting(params, xg, cfg, cap):
        out = route(params, xg, cfg, cap)
        drops.append(int(((out[2] >= 0) & (out[1] == 0)).sum()))
        return out

    route = MOE.route
    monkeypatch.setattr(MOE, "route", counting)
    t_pre = 11
    toks = _tokens(tcfg, t_pre + T_DEC, seed=3)
    _, _, jc = _ref_forward(jcfg, jp, toks[:, :t_pre])
    jst = j_cache_from_prefill(jc, jcfg, B, RING, t_pre)
    tst = cache_from_prefill({k: _t(np.asarray(v)) for k, v in jc.items()},
                             tcfg, B, RING, t_pre)
    for i in range(T_DEC):
        tok = toks[:, t_pre + i:t_pre + i + 1]
        jl, jst = j_decode_step(jp, jnp.asarray(tok), jst,
                                jnp.int32(t_pre + i), jcfg)
        tl, tst = decode_step(model, _t(tok), tst, t_pre + i)
        _close(tl, jl, f"decode logits step {i}")
        assert set(tst) == set(jst)
        for k in jst:
            if kv_quant:
                _equal(tst[k].numpy(), jst[k], f"ring {k} step {i}")
            else:
                _close(tst[k], jst[k], f"ring {k} step {i}")
    assert len(drops) == T_DEC * tcfg.num_layers
    assert sum(drops) > 0


@variants
@pytest.mark.parametrize("t_pre", [11, 100])
def test_prefill_then_decode_continuity(arch, over, t_pre):
    """tests/test_serving.py's contract on the port, at its dropless
    capacity 8.0: decode steps after the hand-off against the full forward
    at 3e-3. At t_pre = 100 mixtral's 64-slot ring (its window) wraps;
    llama4 attends to every position, so its cache holds them all."""
    _, cfg = _cfgs(arch, capacity_factor=8.0, **over)
    model = init_model(cfg, seed=0, device="cpu")
    toks = _t(_tokens(cfg, t_pre + T_DEC, seed=5))
    with torch.inference_mode():
        full, _, _ = forward(model, {"tokens": toks})
    logits_pre, caches = prefill(model, {"tokens": toks[:, :t_pre]})
    cache = RING if cfg.sliding_window else t_pre + T_DEC
    state = cache_from_prefill(caches, cfg, B, cache, t_pre)
    outs = []
    for i in range(T_DEC):
        lg, state = decode_step(model, toks[:, t_pre + i:t_pre + i + 1],
                                state, t_pre + i)
        outs.append(lg[:, 0])
    dec, want = torch.stack(outs, 1), full[:, t_pre:t_pre + T_DEC]
    np.testing.assert_allclose(logits_pre[:, -1].numpy(),
                               full[:, t_pre - 1].numpy(), rtol=3e-3,
                               atol=3e-3)
    np.testing.assert_allclose(dec.numpy(), want.numpy(), rtol=3e-3,
                               atol=3e-3)


@variants
def test_one_attention_per_layer_per_prefill(arch, over, monkeypatch):
    """With counting twins: a prefill makes one swa_attention call per
    layer (with mixtral's window) and no ssd_chunk call; a decode step
    makes neither."""
    counts = {"swa": 0, "ssd": 0}
    windows = set()

    def counting(key, fn):
        def wrapped(*args, **kw):
            counts[key] += 1
            if key == "swa":
                windows.add(kw.get("window"))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(sw, "swa_attention_plain",
                        counting("swa", sw.swa_attention_plain))
    monkeypatch.setattr(sc, "ssd_intra_chunk_grouped_plain",
                        counting("ssd", sc.ssd_intra_chunk_grouped_plain))
    _, cfg = _cfgs(arch, **over)
    model = init_model(cfg, seed=0, device="cpu")
    logits, caches = prefill(model, {"tokens": _t(_tokens(cfg, 30))})
    assert counts == {"swa": cfg.num_layers, "ssd": 0}
    assert windows == {cfg.sliding_window}
    state = cache_from_prefill(caches, cfg, B, RING, 30)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(3):
        tok, state = serve(model, tok, state, 30 + i)
    assert counts == {"swa": cfg.num_layers, "ssd": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_reduced_moe_archs(arch, capsys):
    """``serve.main`` with ``--arch`` and ``--demo`` on the CPU: a 100-token
    prompt (past reduced mixtral's window, so its 64-slot ring wraps),
    then 4 greedy steps."""
    out = cli.main(["--arch", arch, "--demo", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "100", "--steps", "4"])
    printed = capsys.readouterr().out
    assert tuple(out.shape) == (2, 5)
    assert bool(((out >= 0) & (out < 512)).all())
    for line in (f"arch={arch}-reduced", "prefill: 100 tokens", "ms/step",
                 "tok/s", "sampled ids"):
        assert line in printed, printed
