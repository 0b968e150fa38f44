"""Port's audio family (hubert-xlarge: a bidirectional encoder over
projected frame features, ``mask_emb`` in place of the masked frames, an
untied 504-entry unembedding, no decode path), CPU side, on the reduced
config (64-d frames, 4 heads of D = 32) and on reduced hubert with the
full model's head dim of 80 (which the card's kernel pads to 96): the
reference's params carried across with ``params_from_jax``
(``frontend_proj`` and ``mask_emb`` too); ``embed_inputs`` bit-equal with
``mask_indicator`` absent, at the published 0.08 and all ones; the
forward's logits and per-layer caches at T = 40 and 2,112 (past the
reference's flash threshold: its ``_flash`` scan, the port's
``ops.swa_attention`` with ``causal=False`` at both); the encoder is not
causal; the prefill step; one bidirectional attention call per layer;
bf16 params; the decode entry points refused by name; the full config and
its param count from shapes alone; the serve CLI's refusal. Inputs come
from fixed numpy seeds; tolerance is the reference's LM tolerance. A
reduced hubert runs on the card in tests/test_torch_cuda.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.launch.shapes import SHAPES, applicability  # noqa: E402
from repro.launch.steps import abstract_params  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    embed_inputs as j_embed_inputs)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import swa_attention as sw  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch.steps import prefill  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_decode_state, init_model, param_count)
from repro_torch.models.transformer import (  # noqa: E402
    AttentionBlock, LanguageModel, cache_from_prefill, params_from_jax)

# the reference's LM tolerance (tests/test_fused_round.py:57)
TOL = dict(rtol=1e-4, atol=1e-5)
# the reference's bf16 LM tolerance
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B = 2
ARCH = "hubert-xlarge"
# the reduced config (D = 32) and the full model's D = 80
VARIANTS = ({}, dict(head_dim=80))
IDS = ("reduced", "d80")
# mask_indicator absent, drawn at the published mask_prob, all ones
MASKS = (None, 0.08, 1.0)
MASK_IDS = ("no-mask", "mask-0.08", "mask-all")
FULL_PARAMS = 1_260_362_240

variants = pytest.mark.parametrize("over", VARIANTS, ids=IDS)
masks = pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(**over):
    return (dataclasses.replace(j_get_reduced(ARCH), **over),
            dataclasses.replace(get_reduced(ARCH), **over))


def _pair(**over):
    jcfg, tcfg = _cfgs(**over)
    jp = j_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), tcfg, device="cpu")


def _batch(cfg, t, mask=None, seed=0):
    """(B, T, F) frame features and, unless ``mask`` is None, a (B, T)
    int32 mask_indicator drawn at that rate, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"frame_feats": rng.normal(size=(B, t, cfg.frontend_dim))
             .astype(np.float32)}
    if mask is not None:
        batch["mask_indicator"] = (rng.random((B, t)) < mask).astype(
            np.int32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               err_msg=what, **(tol or TOL))


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
    assert (tcfg.family, tcfg.modality) == ("audio", "audio")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(j_get_reduced(ARCH)) == \
        dataclasses.asdict(get_reduced(ARCH))
    assert (tcfg.causal, tcfg.encoder_only, tcfg.supports_decode,
            tcfg.tie_embeddings) == (False, True, False, False)
    assert (tcfg.head_dim, tcfg.frontend_dim, tcfg.mask_prob) == (80, 512,
                                                                  0.08)
    assert get_reduced(ARCH).frontend_dim == 64
    n = sum(int(np.prod(x.shape))
            for x in jax.tree_util.tree_leaves(abstract_params(jcfg)))
    model = _meta_model(jcfg, tcfg)
    assert tuple(model.frontend_proj["w"].shape) == (512, 1280)
    assert tuple(model.mask_emb.shape) == (1280,)
    assert tuple(model.embedding["unembed"].shape) == (1280, 504)
    assert n == param_count(model) == FULL_PARAMS


@variants
def test_init_model_tree_matches_abstract_params(over):
    """The port's init: every leaf of the reference's tree (layers
    unstacked; ``frontend_proj`` (F, d), ``mask_emb`` (d,), the untied
    unembedding), with its shape and dtype, and nothing else."""
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
    assert {"frontend_proj.w", "mask_emb", "embedding.unembed"} <= set(sd)
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert all(isinstance(b, AttentionBlock) for b in model.layers)
    assert model.projector is None


def test_init_model_draws_the_frontend_after_the_trunk():
    """``frontend_proj`` and ``mask_emb`` are drawn last: the trunk's
    weights for a seed are the dense family's for the same shapes."""
    cfg = get_reduced(ARCH)
    audio = init_model(cfg, seed=3, device="cpu").state_dict()
    dense = init_model(dataclasses.replace(
        cfg, family="dense", modality="text", frontend_dim=0, causal=True,
        encoder_only=False), seed=3, device="cpu").state_dict()
    assert set(audio) == set(dense) | {"frontend_proj.w", "mask_emb"}
    for k, v in dense.items():
        assert torch.equal(audio[k], v), k


@variants
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(over, dtype):
    """Every leaf bit for bit, ``frontend_proj`` and ``mask_emb``
    included."""
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


@masks
def test_embed_inputs_matches_reference(mask):
    """The projected frames, ``mask_emb`` where ``mask_indicator`` is set:
    the masked rows are ``mask_emb`` bit for bit, the rest at TOL against
    the reference (the projection is one matmul each side)."""
    jcfg, tcfg, jp, model = _pair()
    batch = _batch(tcfg, 40, mask, seed=1)
    jx, jpos, off = j_embed_inputs(jp, _j(batch), jcfg)
    assert off == 0
    np.testing.assert_array_equal(
        np.asarray(jpos), np.broadcast_to(np.arange(40), (B, 40)))
    with torch.inference_mode():
        x = model.embed_inputs(_t(batch))
    assert tuple(x.shape) == (B, 40, tcfg.d_model)
    _close(x, jx, "embedded frames")
    if mask is not None:
        m = torch.from_numpy(batch["mask_indicator"]).bool()
        assert int(m.sum()) > 0
        assert torch.equal(x[m], model.mask_emb.expand(int(m.sum()), -1))
        np.testing.assert_array_equal(x[m].numpy(),
                                      np.asarray(jx)[m.numpy()])


@variants
@masks
@pytest.mark.parametrize("t", [40, 2112])
def test_forward_logits_and_caches_match_reference(over, mask, t):
    """T = 2,112 is past ATTN_CHUNK_THRESHOLD: the reference takes its
    _flash scan there and its masked einsum at T = 40, both bidirectional;
    the port takes ops.swa_attention with causal off at both.

    At D = 80 and T = 2,112 the K caches are held against the reference
    evaluated op by op (``jax.disable_jit``): jitted, XLA fuses RoPE's
    ``exp`` of the 40 frequencies and rounds some a last bit apart from
    its own op-by-op result (freq[3], about 0.5, by 6e-8), which turns
    the angle at position 2,111 by up to 1.3e-4 rad, and K by as much
    relative to its size. The port's K is within TOL of the op-by-op
    reference's. The jitted K is held within that angle's reach."""
    jcfg, tcfg, jp, model = _pair(**over)
    assert not tcfg.causal and tcfg.sliding_window is None
    assert (t > JL.ATTN_CHUNK_THRESHOLD) == (t == 2112)
    batch = _batch(tcfg, t, mask, seed=t)
    jlog, _, jc = j_forward(jp, _j(batch), jcfg, return_cache=True)
    with torch.inference_mode():
        tlog, aux, tc = forward(model, _t(batch), return_cache=True)
    assert tuple(tlog.shape) == (B, t, tcfg.vocab_size)
    _close(tlog, jlog, f"logits T={t}")
    assert float(aux) == 0.0
    k_ref = jc["k"]
    if tcfg.head_dim == 80 and t == 2112:
        with jax.disable_jit():
            _, _, op_by_op = j_forward(jp, _j(batch), jcfg,
                                       return_cache=True)
        k_ref = op_by_op["k"]
        _close(tc["v"], op_by_op["v"], "cache v, op by op")
        jit_k = np.asarray(jc["k"])
        assert np.abs(jit_k - np.asarray(k_ref)).max() < \
            2.5e-4 * np.abs(jit_k).max()
    for k, want in (("k", k_ref), ("v", jc["v"])):
        assert tuple(tc[k].shape) == (tcfg.num_layers, B, t,
                                      tcfg.num_kv_heads, tcfg.head_dim)
        _close(tc[k], want, f"cache {k} T={t}")


@variants
def test_bf16_forward_matches_reference(over):
    """bf16 params on both sides: the forward's logits at the reference's
    bf16 tolerance, with the mask at the published rate."""
    jcfg, tcfg, jp, model = _pair(param_dtype="bfloat16", **over)
    batch = _batch(tcfg, 40, 0.08, seed=2)
    jlog, _, _ = j_forward(jp, _j(batch), jcfg)
    with torch.inference_mode():
        tlog, _, _ = forward(model, _t(batch))
    assert tlog.dtype == torch.float32
    _close(tlog, jlog, "bf16 logits", **BF16_TOL)


def test_encoder_is_not_causal():
    """The reference's property (tests/test_properties.py
    test_encoder_is_not_causal) on the port: changing frames 20 and later
    moves the logits of frames 0-9; the same on the reference's params
    moves them alike."""
    jcfg, tcfg, jp, model = _pair()
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(1, 24, tcfg.frontend_dim)).astype(np.float32)
    feats2 = feats.copy()
    feats2[:, 20:] += 3.0
    zeros = np.zeros((1, 24), np.int32)
    outs = []
    for f in (feats, feats2):
        batch = {"frame_feats": f, "mask_indicator": zeros}
        with torch.inference_mode():
            tl, _, _ = forward(model, _t(batch))
        jl, _, _ = j_forward(jp, _j(batch), jcfg)
        _close(tl, jl, "logits")
        outs.append(tl)
    assert float((outs[0][:, :10] - outs[1][:, :10]).abs().max()) > 1e-4


@variants
def test_prefill_step_gives_the_last_frame_and_no_caches(over, monkeypatch):
    """The prefill step on an encoder-only config: the last position's
    logits, as the reference's ``logits[:, -1:]``, and no caches; one
    bidirectional swa_attention call per layer over all T frames."""
    calls = []
    plain = sw.swa_attention_plain

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], kw.get("window"), kw.get("causal")))
        return plain(q, k, v, **kw)

    jcfg, tcfg, jp, model = _pair(**over)
    batch = _batch(tcfg, 50, 0.08, seed=4)
    jlog, _, _ = j_forward(jp, _j(batch), jcfg)
    monkeypatch.setattr(sw, "swa_attention_plain", counting)
    last, caches = prefill(model, _t(batch))
    assert caches is None
    assert calls == [(50, None, False)] * tcfg.num_layers
    _close(last, np.asarray(jlog)[:, -1:], "prefill logits")


def test_decode_entry_points_raise_naming_encoder_only():
    """The reference has no decode path for hubert (its shapes skip the
    decode cells, its serve example exits): the port's decode state, the
    hand-off and the decode step raise naming ``encoder_only``."""
    cfg = get_reduced(ARCH)
    for shape in SHAPES.values():
        if shape.kind == "decode":
            assert not applicability(j_get_reduced(ARCH), shape)[0]
    model = init_model(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder_only"):
        init_decode_state(cfg, B, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder_only"):
        model.init_decode_state(B, 64)
    with pytest.raises(NotImplementedError, match="encoder_only"):
        cache_from_prefill({"k": torch.zeros(1), "v": torch.zeros(1)}, cfg,
                           B, 64, 11)
    with pytest.raises(NotImplementedError, match="encoder_only"):
        decode_step(model, torch.zeros((B, 1), dtype=torch.int32), {}, 0)


def test_serve_cli_exits_naming_the_arch():
    for argv in (["--arch", ARCH, "--demo", "--device", "cpu"],
                 ["--arch", "hubert_xlarge", "--device", "cpu"]):
        with pytest.raises(SystemExit, match="hubert.xlarge is "
                                             "encoder-only"):
            cli.main(argv)
