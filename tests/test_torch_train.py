"""Port's LM loss, CPU side, against the reference on the same inputs:
``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of the
reference's ``loss_fn`` (weights carried across with ``params_from_jax``)
for reduced dense, moe, vlm, audio, ssm and hybrid configs, and with
block remat. The streamed cross-entropy and the T = 2,112 case are held
in tests/test_torch_train_stream.py; the optimizers, ``token_stream``,
the PAOTA train step and the train CLI in tests/test_torch_train_step.py.
Inputs come from fixed numpy seeds; tolerance is the reference's LM
tolerance."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

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


@pytest.mark.parametrize("family,remat", [
    (f, "none") for f in FAMILIES] + [("dense", "block"), ("moe", "block"),
                                      ("hybrid", "block")])
def test_loss_and_grads_match_reference(family, remat):
    """Every family's loss, aux and gradients at T = 24; block remat (the
    reference's jax.checkpoint per layer, the port's torch.utils.checkpoint
    per block) for an attention trunk, the MoE layer and the hybrid
    family's shared block beside the Mamba2 layers."""
    jcfg, jp, model = _pair(FAMILIES[family], remat=remat)
    _check_loss_and_grads(jcfg, jp, model, _batch(jcfg, 24, seed=1))
