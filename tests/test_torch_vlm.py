"""Port's vlm family (internvl2-1b: a dense decoder over [projected patch
embeddings; text tokens], 14 query heads over 2, tied embeddings), CPU
side, on the reduced config (8 patches of 64-d, 4 heads over 1) and on
reduced internvl with 14 query heads over 2 (the full model's GQA group of
7): the reference's params carried across with ``params_from_jax`` (the
projector too); ``embed_inputs``; the forward's logits and per-layer
caches over P + T = 48 and 2,112 positions (past the reference's flash
threshold: its ``_flash`` scan, the port's ``ops.swa_attention`` at
both); the prefill -> decode hand-off over the P + T prefill positions
(rings, f32 and int8 with f16 scales, bit-equal to the reference's, with
and without a wrap); teacher-forced decode from index P + T; continuity;
one attention call per layer per prefill; bf16 params; the full config
and its param count from shapes alone; the serve CLI. Inputs come from
fixed numpy seeds; tolerance is the reference's LM tolerance. A reduced
internvl runs on the card in tests/test_torch_cuda.py."""
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
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    cache_from_prefill as j_cache_from_prefill)
from repro.models.transformer import (  # noqa: E402
    embed_inputs as j_embed_inputs)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch.steps import prefill, serve  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_model, param_count)
from repro_torch.models.transformer import (  # noqa: E402
    AttentionBlock, LanguageModel, cache_from_prefill, params_from_jax)

# the reference's LM tolerance (tests/test_fused_round.py:57)
TOL = dict(rtol=1e-4, atol=1e-5)
# the reference's bf16 LM tolerance
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, T_DEC, RING = 2, 6, 64
ARCH = "internvl2-1b"
# the reduced config (4 heads over 1) and a GQA group of 7 (14 over 2), as
# the full model's
VARIANTS = ({}, dict(num_heads=14, num_kv_heads=2))
IDS = ("reduced", "gqa7")
FULL_PARAMS = 494_670_848

variants = pytest.mark.parametrize("over", VARIANTS, ids=IDS)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(**over):
    return (dataclasses.replace(j_get_reduced(ARCH), **over),
            dataclasses.replace(get_reduced(ARCH), **over))


def _pair(**over):
    jcfg, tcfg = _cfgs(**over)
    jp = j_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), tcfg, device="cpu")


def _batch(cfg, t, seed=0):
    """(B, P, F) patch embeddings and (B, T) text tokens, as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, t)).astype(
                np.int32),
            "patch_embeds": rng.normal(size=(B, cfg.num_patches,
                                             cfg.frontend_dim)).astype(
                np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               err_msg=what, **(tol or TOL))


def _equal(got, want, what):
    assert str(got.dtype).split(".")[-1] == np.asarray(want).dtype.name, what
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def _meta_model(jcfg, tcfg) -> LanguageModel:
    """The port's module over the reference's abstract params, as meta
    tensors (no memory): the full config's count without an init."""
    tree = abstract_params(jcfg)

    def conv(node, layer=None):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v, layer) for k, v in node.items()}
        shape = node.shape if layer is None else node.shape[1:]
        return torch.empty(shape, device="meta")

    params = {k: conv(v) for k, v in tree.items() if k != "layers"}
    params["layers"] = [conv(tree["layers"], i)
                        for i in range(tcfg.num_layers)]
    return LanguageModel(tcfg, params)


def test_full_config_matches_reference_and_counts_params():
    """The published config and its reduced variant equal the reference's;
    the param count from shapes alone (the reference's ``abstract_params``,
    the port's module on the meta device): no full-width init here."""
    jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    assert (tcfg.family, tcfg.modality) == ("vlm", "vision_text")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(j_get_reduced(ARCH)) == \
        dataclasses.asdict(get_reduced(ARCH))
    assert (tcfg.num_patches, tcfg.frontend_dim) == (256, 1024)
    assert (get_reduced(ARCH).num_patches,
            get_reduced(ARCH).frontend_dim) == (8, 64)
    assert tcfg.supports_decode and tcfg.causal
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(abstract_params(jcfg)))
    model = _meta_model(jcfg, tcfg)
    assert tuple(model.projector["w"].shape) == (1024, 896)
    assert n == param_count(model) == FULL_PARAMS


def test_gqa7_variant_is_a_valid_reference_config():
    jcfg, tcfg = _cfgs(**VARIANTS[1])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.num_heads // tcfg.num_kv_heads, tcfg.head_dim) == (7, 32)


@variants
def test_init_model_tree_matches_abstract_params(over):
    """The port's init: every leaf of the reference's tree (layers
    unstacked, the projector (F, d)), with its shape and dtype, and
    nothing else."""
    jcfg, tcfg = _cfgs(**over)
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
    assert "projector.w" in sd and "embedding.unembed" not in sd
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert all(isinstance(b, AttentionBlock) for b in model.layers)
    assert model.frontend_proj is None and model.mask_emb is None


def test_init_model_draws_the_projector_after_the_trunk():
    """The projector is drawn last: the trunk's weights for a seed are the
    dense family's for the same shapes."""
    cfg = get_reduced(ARCH)
    vlm = init_model(cfg, seed=3, device="cpu").state_dict()
    dense = init_model(dataclasses.replace(
        cfg, family="dense", modality="text", num_patches=0,
        frontend_dim=0), seed=3, device="cpu").state_dict()
    assert set(vlm) == set(dense) | {"projector.w"}
    for k, v in dense.items():
        assert torch.equal(vlm[k], v), k


@variants
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(over, dtype):
    """Every leaf bit for bit, the projector included."""
    jcfg, tcfg, jp, model = _pair(param_dtype=dtype, **over)
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


@variants
def test_embed_inputs_matches_reference(over):
    """[projected patches; token embeddings] (B, P + T, d), against the
    reference's ``embed_inputs`` at TOL (the projector is one matmul)."""
    jcfg, tcfg, jp, model = _pair(**over)
    batch = _batch(tcfg, 20, seed=1)
    jx, jpos, off = j_embed_inputs(jp, _j(batch), jcfg)
    assert off == tcfg.num_patches
    np.testing.assert_array_equal(
        np.asarray(jpos), np.broadcast_to(np.arange(28), (B, 28)))
    with torch.inference_mode():
        x = model.embed_inputs(_t(batch))
    assert tuple(x.shape) == (B, tcfg.num_patches + 20, tcfg.d_model)
    _close(x, jx, "embedded inputs")
    # the text part is the embedding table's rows exactly
    _equal(x[:, tcfg.num_patches:], np.asarray(jx)[:, tcfg.num_patches:],
           "token embeddings")


@variants
@pytest.mark.parametrize("t_text", [40, 2104])
def test_forward_logits_and_caches_match_reference(over, t_text):
    """P + T = 2,112 positions are past ATTN_CHUNK_THRESHOLD: the reference
    takes its _flash scan there and its masked einsum at P + T = 48; the
    port takes ops.swa_attention over the full causal triangle at both.
    Logits and caches cover the patches' positions too."""
    jcfg, tcfg, jp, model = _pair(**over)
    n = tcfg.num_patches + t_text
    assert (n > JL.ATTN_CHUNK_THRESHOLD) == (t_text == 2104)
    batch = _batch(tcfg, t_text, seed=t_text)
    jlog, _, jc = j_forward(jp, _j(batch), jcfg, return_cache=True)
    with torch.inference_mode():
        tlog, aux, tc = forward(model, _t(batch), return_cache=True)
    assert tuple(tlog.shape) == (B, n, tcfg.vocab_size)
    _close(tlog, jlog, f"logits P+T={n}")
    assert float(aux) == 0.0
    assert set(tc) == set(jc) == {"k", "v"}
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == (tcfg.num_layers, B, n,
                                      tcfg.num_kv_heads, tcfg.head_dim)
        _close(tc[k], jc[k], f"cache {k} P+T={n}")


@variants
def test_bf16_forward_matches_reference(over):
    """bf16 params on both sides: the forward's logits at the reference's
    bf16 tolerance."""
    jcfg, tcfg, jp, model = _pair(param_dtype="bfloat16", **over)
    batch = _batch(tcfg, 40, seed=2)
    jlog, _, _ = j_forward(jp, _j(batch), jcfg)
    with torch.inference_mode():
        tlog, _, _ = forward(model, _t(batch))
    assert tlog.dtype == torch.float32
    _close(tlog, jlog, "bf16 logits", **BF16_TOL)


@variants
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("t_text", [3, 92])
def test_cache_from_prefill_rings_bit_equal(over, kv_quant, t_text):
    """The reference's own prefill caches through both hand-offs over
    P + T prefill positions: 11 fill slots [0, 11) of the 64-slot ring;
    100 wrap it, each position p in slot p % 64. Under kv_quant the int8
    payloads and the f16 scales are bit-equal."""
    jcfg, tcfg, jp, _ = _pair(kv_quant=kv_quant, **over)
    n = tcfg.num_patches + t_text
    _, _, jc = j_forward(jp, _j(_batch(tcfg, t_text, seed=n)), jcfg,
                         return_cache=True)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    jst = j_cache_from_prefill(jc, jcfg, B, RING, n)
    tst = cache_from_prefill(tc, tcfg, B, RING, n)
    names = {"k", "v"} | ({"k_scale", "v_scale"} if kv_quant else set())
    assert set(tst) == set(jst) == names
    for k in names:
        assert tst[k].shape[:3] == (tcfg.num_layers, B, RING)
        _equal(tst[k], jst[k], f"ring {k}")


@variants
@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_steps_match_reference(over, kv_quant):
    """Teacher-forced: the reference's caches of [8 patches; 3 tokens]
    handed off by each package, then 6 decode steps from index P + T = 11
    (tokens only: the reference's decode_step ignores patch_embeds), each
    step's logits and rings against the reference on the same tokens: the
    f32 rings at TOL; the f16 scales bit-equal; the int8 payloads equal
    but where a decode token's f32 K or V, which the two packages round
    apart in its last bits (one f32 matmul each), sits on a rounding
    boundary: there one step apart, in under 0.1% of the entries."""
    jcfg, tcfg, jp, model = _pair(kv_quant=kv_quant, **over)
    t_text = 3
    n = tcfg.num_patches + t_text
    batch = _batch(tcfg, t_text + T_DEC, seed=3)
    pre = dict(batch, tokens=batch["tokens"][:, :t_text])
    _, _, jc = j_forward(jp, _j(pre), jcfg, return_cache=True)
    jst = j_cache_from_prefill(jc, jcfg, B, RING, n)
    tst = cache_from_prefill({k: torch.from_numpy(np.array(v))
                              for k, v in jc.items()}, tcfg, B, RING, n)
    toks = batch["tokens"]
    for i in range(T_DEC):
        tok = toks[:, t_text + i:t_text + i + 1]
        jl, jst = j_decode_step(jp, jnp.asarray(tok), jst, jnp.int32(n + i),
                                jcfg)
        tl, tst = decode_step(model, torch.from_numpy(tok), tst, n + i)
        _close(tl, jl, f"decode logits step {i}")
        assert set(tst) == set(jst)
        for k in jst:
            if not kv_quant:
                _close(tst[k], jst[k], f"ring {k} step {i}")
            elif k.endswith("_scale"):
                _equal(tst[k], jst[k], f"ring {k} step {i}")
            else:
                assert tst[k].dtype == torch.int8
                off = (tst[k].int() - torch.from_numpy(
                    np.asarray(jst[k]).astype(np.int32))).abs()
                assert int(off.max()) <= 1, f"ring {k} step {i}"
                assert float((off > 0).float().mean()) < 1e-3, \
                    f"ring {k} step {i}"


@variants
def test_prefill_then_decode_continuity(over):
    """tests/test_serving.py's contract on the port: the prefill step over
    [patches; 11 tokens], its hand-off, then decode steps from index
    P + 11 against the full forward over [patches; 17 tokens], at 3e-3."""
    _, cfg = _cfgs(**over)
    model = init_model(cfg, seed=0, device="cpu")
    t_text, p = 11, cfg.num_patches
    batch = _t(_batch(cfg, t_text + T_DEC, seed=5))
    with torch.inference_mode():
        full, _, _ = forward(model, batch)
    logits_pre, caches = prefill(
        model, dict(batch, tokens=batch["tokens"][:, :t_text]))
    state = cache_from_prefill(caches, cfg, B, RING, p + t_text)
    toks = batch["tokens"]
    outs = []
    for i in range(T_DEC):
        lg, state = decode_step(model, toks[:, t_text + i:t_text + i + 1],
                                state, p + t_text + i)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    want = full[:, p + t_text:p + t_text + T_DEC]
    np.testing.assert_allclose(logits_pre[:, -1].numpy(),
                               full[:, p + t_text - 1].numpy(), rtol=3e-3,
                               atol=3e-3)
    np.testing.assert_allclose(dec.numpy(), want.numpy(), rtol=3e-3,
                               atol=3e-3)


def test_one_attention_per_layer_per_prefill(monkeypatch):
    """With a counting twin: a prefill over [patches; text] makes one causal
    swa_attention call per layer over all P + T positions; a decode step
    makes none."""
    calls = []

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], kw.get("causal", True)))
        return plain(q, k, v, **kw)

    plain = sw.swa_attention_plain
    monkeypatch.setattr(sw, "swa_attention_plain", counting)
    _, cfg = _cfgs(**VARIANTS[1])
    model = init_model(cfg, seed=0, device="cpu")
    logits, caches = prefill(model, _t(_batch(cfg, 30)))
    n = cfg.num_patches + 30
    assert calls == [(n, True)] * cfg.num_layers
    state = cache_from_prefill(caches, cfg, B, RING, n)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(3):
        tok, state = serve(model, tok, state, n + i)
    assert len(calls) == cfg.num_layers


@pytest.mark.parametrize("prompt_len", [0, 20])
def test_serve_cli_runs_the_reduced_vlm(prompt_len, capsys):
    """``serve.main`` with ``--arch internvl2-1b --demo`` on the CPU: with
    no prompt it decodes from a zero state (the reference's serve
    example); with one, it prefills [8 random patches; 20 tokens] and
    decodes from index 28."""
    argv = ["--arch", ARCH, "--demo", "--device", "cpu", "--batch", "2",
            "--steps", "4"]
    if prompt_len:
        argv += ["--prompt-len", str(prompt_len)]
    out = cli.main(argv)
    printed = capsys.readouterr().out
    assert tuple(out.shape) == (2, 5)
    assert bool(((out >= 0) & (out < 512)).all())
    lines = [f"arch={ARCH}-reduced", "ms/step", "tok/s", "sampled ids"]
    if prompt_len:
        lines.append("prefill: 8 patches + 20 tokens")
    for line in lines:
        assert line in printed, printed
