"""The steps on one device: the bodies of the reference's
``make_prefill_step``, ``make_serve_step`` and ``make_paota_train_step``
(``repro/launch/steps.py``).

The reference jits them over a mesh with explicit shardings; the port runs
them eagerly on one device, serving under ``torch.inference_mode()``. The
mesh and the shardings belong to the multi-device slice: the train step
takes its client count K from the caller, the one thing the reference's
mesh gave it.

The PAOTA train step keeps the K clients' params in one stacked store in
the reference's layout and leaf order (``stack_params``): a params tree of
(K, ...) leaves, the layer leaves (K, L, ...). A client trains views of
its row of that store through ``torch.func.functional_call``, so a round
copies no model per client, and the round's aggregation sweeps the store
once per reference leaf (sweep 2, ``superpose_normalize``) with one flat
AWGN draw split over the leaves (``core.aggregation.stacked_tree_noise``),
which lands on the same weights as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.core.aggregation import paota_aggregate_stacked
from repro_torch.device import f32
from repro_torch.launch.shapes import InputShape, shape_config
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import loss_fn
from repro_torch.tree import build, tree_leaves


def prefill(model, batch):
    """Forward over the prompt batch (``tokens``; vlm: ``patch_embeds``
    too; audio: ``frame_feats`` and an optional ``mask_indicator``):
    ``(logits (B, 1, V) of the last position, caches)``, the caches None
    for an encoder-only config. Only the last position is unembedded; the
    logits are the reference's ``logits[:, -1:, :]``."""
    cfg = model.cfg
    with torch.inference_mode():
        hidden, _, caches = model(batch, return_cache=cfg.supports_decode,
                                  return_hidden=True)
        return L.unembed(model.embedding, hidden[:, -1:], cfg), caches


def serve(model, tokens, state, index):
    """One greedy decode step: ``(next tokens (B, 1) int32, new state)``."""
    with torch.inference_mode():
        logits, new_state = model.decode_step(tokens, state, index)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_state


# ---------------------------------------------------------------------------
# PAOTA train step
# ---------------------------------------------------------------------------

def runtime_config(cfg: ModelConfig, shape: Optional[InputShape] = None):
    """The production config: bf16 params and compute, block remat."""
    if shape is not None:
        cfg = shape_config(cfg, shape)
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16", remat="block")


def train_batch_shapes(cfg: ModelConfig, shape: InputShape, k_clients: int,
                       local_steps: int) -> dict:
    """The reference's ``train_batch_struct``: name -> (shape, dtype) of the
    (K, M, mb, ...) batch, mb = global_batch / K."""
    mb = max(shape.global_batch // max(k_clients, 1), 1)
    s = shape.seq_len
    lead = (k_clients, local_steps, mb)
    if cfg.modality == "audio":
        return {"frame_feats": (lead + (s, cfg.frontend_dim),
                                L.torch_dtype(cfg.compute_dtype)),
                "mask_indicator": (lead + (s,), torch.int32),
                "targets": (lead + (s,), torch.int32)}
    if cfg.modality == "vision_text":
        return {"tokens": (lead + (max(s - cfg.num_patches, 8),),
                           torch.int32),
                "patch_embeds": (lead + (cfg.num_patches, cfg.frontend_dim),
                                 L.torch_dtype(cfg.compute_dtype))}
    return {"tokens": (lead + (s,), torch.int32)}


def param_layout(model: nn.Module) -> list:
    """The reference's leaves in its leaf order: (path, the module's param
    names) pairs, a layer leaf's path ``("layers", ...)`` naming its L
    params in layer order (``layers.<i>.<rest>``), any other path one
    param."""
    groups: dict = {}
    for name, _ in model.named_parameters():
        parts = tuple(name.split("."))
        path = ("layers",) + parts[2:] if parts[0] == "layers" else parts
        groups.setdefault(path, []).append(name)
    return sorted(groups.items())


def stack_params(model: nn.Module, k_clients: int) -> dict:
    """Every client's copy of ``model``'s params in one store: the
    reference's params tree (its ``init_model`` layout) stacked K times,
    (K, ...) leaves and (K, L, ...) layer leaves."""
    params = dict(model.named_parameters())
    paths, leaves = [], []
    for path, names in param_layout(model):
        one = (torch.stack([params[n].detach() for n in names])
               if path[0] == "layers" else params[names[0]].detach())
        paths.append(path)
        leaves.append(one.unsqueeze(0).repeat(
            (k_clients,) + (1,) * one.dim()))
    return build(paths, leaves)


def client_params(layout, leaves, prefix: str = "") -> dict:
    """One client's params by module name, as views of its leaves (its row
    of the store, in ``param_layout``'s order): a layer leaf unbound into
    its L layers."""
    mapping = {}
    for (path, names), leaf in zip(layout, leaves):
        views = leaf.unbind(0) if path[0] == "layers" else (leaf,)
        mapping.update({prefix + n: x for n, x in zip(names, views)})
    return mapping


class KeyedNormal:
    """The card's draw source for the round's AWGN: a standard normal (d,)
    f32 draw from a ``torch.Generator`` keyed on (seed, round key), so a
    round's noise does not depend on what ran before it. Tests pass the
    reference's own draws instead (any callable ``(key, d, device)``)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def __call__(self, key: int, d: int, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(
            (self.seed * 1_000_003 + int(key)) % 2**63)
        return torch.randn((d,), generator=gen, device=device)


class _ClientLoss(nn.Module):
    """A client's loss and gradients in one call, so that everything the
    backward recomputes (remat blocks, cross-entropy chunks) runs while
    ``functional_call`` holds the client's params in place."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, leaves):
        total, _ = loss_fn(self.model, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        return total.detach(), grads


ACCUM_TOKENS = 262144    # tokens per accumulation chunk (the reference's)


def make_paota_train_step(model: nn.Module, shape: InputShape,
                          k_clients: int, *, lr: float = 1e-3,
                          local_steps: int = 5,
                          sigma_over_varsigma: float = 1e-4,
                          noise=None):
    """The PAOTA round on one device (the reference's
    ``make_paota_train_step``): ``step(stacked, batch, powers, mask, seed)
    -> (stacked, metrics)``.

    ``stacked`` is ``stack_params(model, K)``'s store, updated in place and
    returned; ``batch`` the (K, M, mb, ...) tensors of
    ``train_batch_shapes``; ``powers`` and ``mask`` (K,) f32; ``seed`` the
    round's key for the draw source ``noise`` (default ``KeyedNormal()``).
    Each client takes M SGD steps at ``lr`` on ``loss_fn``, in ``accum``
    chunks of its microbatch with a bf16 gradient sum where the step holds
    more than 2 x 262,144 tokens (the reference's rule); then sigma =
    sigma_over_varsigma * max(sum b p, 1e-12) and ``paota_aggregate_stacked``
    runs one sweep 2 per reference leaf on sigma times the (d,) draw
    (sigma_over_varsigma = 0: the noiseless contraction, no sweep);
    participants (mask 1) take the aggregate and stragglers keep their
    local params. Leaves keep the store's dtype. Metrics: ``loss`` (the
    mean of the K x M step losses), ``varsigma``, ``participants``."""
    k = max(int(k_clients), 1)
    noise = KeyedNormal() if noise is None else noise
    mb_total = max(shape.global_batch // k, 1)
    accum = max(1, min(mb_total, mb_total * shape.seq_len // ACCUM_TOKENS))
    while mb_total % accum:
        accum -= 1
    layout = param_layout(model)
    client = _ClientLoss(model)

    def grads(leaves, mb):
        return functional_call(client, client_params(layout, leaves, "model."),
                               (mb, leaves))

    def sgd_step(leaves, mb):
        if accum == 1:
            loss, g = grads(leaves, mb)
        else:
            g = [torch.zeros_like(p, dtype=torch.bfloat16) for p in leaves]
            loss = torch.zeros((), device=leaves[0].device)
            for i in range(accum):
                chunk = {n: x.reshape((accum, -1) + x.shape[1:])[i]
                         for n, x in mb.items()}
                l_i, g_i = grads(leaves, chunk)
                for a, gp in zip(g, g_i):
                    a.add_(gp.to(torch.bfloat16))
                loss = loss + l_i
        with torch.no_grad():
            for p, gp in zip(leaves, g):
                p.copy_(p - f32(lr / accum) * gp.float())
        return loss / accum

    def step(stacked, batch, powers, mask, seed):
        store = tree_leaves(stacked)
        losses = []
        for c in range(k):
            leaves = [s[c].detach().requires_grad_() for s in store]
            for m in range(local_steps):
                losses.append(sgd_step(
                    leaves, {n: x[c, m] for n, x in batch.items()}))
        bp = powers * mask
        nz = None
        if sigma_over_varsigma > 0:
            sigma = f32(sigma_over_varsigma) * torch.clamp_min(
                bp.sum(), f32(1e-12))
            d = sum(s[0].numel() for s in store)
            nz = sigma * noise(seed, d, powers.device)
        agg, varsigma = paota_aggregate_stacked(stacked, powers, mask, nz)
        with torch.no_grad():
            for s, a in zip(store, tree_leaves(agg)):
                m = mask.reshape((k,) + (1,) * (s.dim() - 1)).to(s.dtype)
                s.copy_(m * a[None] + (1 - m) * s)
        metrics = {"loss": torch.stack(losses).mean(), "varsigma": varsigma,
                   "participants": mask.sum()}
        return stacked, metrics

    return step
