"""The paper's own model, torch form: an MLP with two hidden layers of 10
units for 10-class MNIST-like classification (Section IV-A).

Port of ``repro.models.mlp``. Params are a nested dict
``{"l1": {"w": (784, 10), "b": (10,)}, "l2": ..., "l3": ...}`` of f32
tensors, the reference's pytree layout, so the raveled vector
(``repro_torch.core.aggregation.ravel``) has the reference's leaf order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device


def init_mlp_params(seed: int = 0, d_in: int = 784, hidden: int = 10,
                    n_classes: int = 10):
    """He-normal weights and zero biases from a seeded torch generator
    (a different stream from the reference's; parity tests carry the
    reference's params across with ``params_from_jax``)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))

    def lin(i, o):
        w = torch.randn((i, o), generator=gen) * math.sqrt(2.0 / i)
        return {"w": w, "b": torch.zeros((o,))}

    return {"l1": lin(d_in, hidden), "l2": lin(hidden, hidden),
            "l3": lin(hidden, n_classes)}


def params_from_jax(np_params, device=None):
    """The reference's params pytree, carried across as numpy arrays, as a
    nested dict of f32 tensors on ``device`` (same keys, same shapes;
    ``None`` is the card, as for every entry point of the port)."""
    dev = resolve_device(device)
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, dev) for k, v in np_params.items()}
    return torch.as_tensor(np.array(np_params, dtype=np.float32), device=dev)


def mlp_apply(params, x):
    h = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    h = torch.relu(h @ params["l2"]["w"] + params["l2"]["b"])
    return h @ params["l3"]["w"] + params["l3"]["b"]


def mlp_loss(params, batch):
    """Mean softmax cross-entropy of one client's minibatch."""
    logits = mlp_apply(params, batch["x"])
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["y"].unsqueeze(-1)).squeeze(-1)
    return (lse - ll).mean()


def mlp_accuracy(params, batch):
    logits = mlp_apply(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).float().mean()
