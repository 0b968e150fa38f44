"""Port's LM loss on long inputs, CPU side, against the reference on the
same inputs: the streamed cross-entropy inside ``loss_fn`` (both
packages' threshold lowered) for the dense, vlm, audio and moe families,
one dense case at T = 2,112 through the reference's ``_flash`` VJP, and
``_xent_chunked`` against the reference's called directly, tied and
untied: the value and every gradient leaf against ``jax.value_and_grad``
(weights carried across with ``params_from_jax``). Inputs come from fixed
numpy seeds; tolerance is the reference's LM tolerance."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as JL  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)     # the reference's LM tolerance
B = 2
FAMILIES = {"dense": "smollm-135m", "moe": "mixtral-8x22b",
            "vlm": "internvl2-1b", "audio": "hubert-xlarge",
            "ssm": "mamba2-370m", "hybrid": "zamba2-7b"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **over):
    jcfg = dataclasses.replace(j_get_reduced(arch), **over)
    tcfg = dataclasses.replace(get_reduced(arch), **over)
    jp = jax.jit(lambda key: j_init_model(key, jcfg))(jax.random.PRNGKey(0))
    model = TT.params_from_jax(_np(jp), tcfg, device="cpu")
    return jcfg, jp, model


def _batch(cfg, t, seed=0, lead=(B,)):
    """The family's batch as numpy: tokens; vlm patch embeddings; audio
    frames, a mask at 0.3 and targets."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        return {"frame_feats": rng.normal(
                    size=lead + (t, cfg.frontend_dim)).astype(np.float32),
                "mask_indicator": (rng.random(lead + (t,)) < 0.3).astype(
                    np.int32),
                "targets": rng.integers(0, cfg.vocab_size,
                                        lead + (t,)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    lead + (t,)).astype(np.int32)}
    if cfg.modality == "vision_text":
        batch["patch_embeds"] = rng.normal(
            size=lead + (cfg.num_patches, cfg.frontend_dim)).astype(
                np.float32)
    return batch


def _ref_value_and_grad(cfg):
    return jax.jit(lambda p, b: jax.value_and_grad(
        JT.loss_fn, has_aux=True)(p, b, cfg))


def _port_grads(model):
    """The port's gradients in the reference's leaves and leaf order (zero
    where a param takes none: hubert's unused token embedding)."""
    params = dict(model.named_parameters())

    def grad(name):
        g = params[name].grad
        return torch.zeros_like(params[name]) if g is None else g

    return [torch.stack([grad(n) for n in names])
            if path[0] == "layers" else grad(names[0])
            for path, names in steps.param_layout(model)]


def _check_loss_and_grads(jcfg, jp, model, batch):
    (jv, jm), jg = _ref_value_and_grad(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model.trainable()
    total, metrics = TT.loss_fn(model, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jv), **TOL)
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jm[key]), **TOL)
    want = jax.tree_util.tree_leaves_with_path(jg)
    got = _port_grads(model)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("family", ["dense", "vlm", "audio", "moe"])
def test_streamed_loss_and_grads_match_reference(family, monkeypatch):
    """The streamed cross-entropy inside loss_fn: both packages' threshold
    lowered so T = 600 tokens stream in chunks of 512 (one padded)."""
    for mod in (JT, TT):
        monkeypatch.setattr(mod, "XENT_CHUNK_THRESHOLD", 1000)
    jcfg, jp, model = _pair(FAMILIES[family])
    _check_loss_and_grads(jcfg, jp, model, _batch(jcfg, 600, seed=2))


def test_dense_at_2112_matches_reference_flash_vjp(monkeypatch):
    """T = 2,112, past the reference's 2,048-key threshold: its attention
    runs _flash and its custom VJP (_flash_bwd), the port's the twin under
    autograd. The reference's chunk is cut from 1,024 to 64 (2,112 = 33 x
    64): at 1,024 its _flash_bwd hands back the padded key positions'
    cotangent and jax refuses its shape (a reference-side fact)."""
    def attend_chunked(q, k, v, cfg, q_pos, k_pos, window, causal,
                       chunk=64):
        return JL._flash(q, k, v, q_pos.astype(jnp.float32),
                         k_pos.astype(jnp.float32), window, causal, chunk)

    monkeypatch.setattr(JL, "_attend_chunked", attend_chunked)
    jcfg, jp, model = _pair("smollm-135m")
    _check_loss_and_grads(jcfg, jp, model,
                          _batch(jcfg, 2112, seed=3, lead=(1,)))


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-3-8b"])
def test_xent_chunked_matches_reference(arch):
    """_xent_chunked called directly, tied (smollm) and untied (granite):
    T = 1,100 in three chunks, the last padded, under a mask; the value and
    the gradients of the hidden states and the unembedding."""
    jcfg, jp, model = _pair(arch)
    rng = np.random.default_rng(4)
    t = 1100
    hidden = rng.normal(size=(B, t, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, t)).astype(np.int32)
    mask = (rng.random((B, t)) < 0.7).astype(np.float32)

    def ref(emb, h):
        return JT._xent_chunked({"embedding": emb}, h, jnp.asarray(labels),
                                jnp.asarray(mask), jcfg)

    want, (g_emb, g_h) = jax.value_and_grad(ref, argnums=(0, 1))(
        jp["embedding"], jnp.asarray(hidden))
    model.trainable()
    h = torch.from_numpy(hidden).requires_grad_()
    got = TT._xent_chunked(model.embedding, h, torch.from_numpy(labels),
                           torch.from_numpy(mask), model.cfg)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(g_h), **TOL)
    for name, w in g_emb.items():
        g = model.embedding[name].grad      # None: untied, embed unused
        got = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(w), **TOL, err_msg=name)
