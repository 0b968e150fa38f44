"""Minimal functional optimizers (optax-like init / update pairs) on params
dicts of tensors, torch form of ``repro.optim.optimizers``.

The paper's clients run plain SGD (eq. 3), as the PAOTA train step does;
AdamW is here for the datacenter training examples. A params tree is a
nested dict of tensors walked in the reference's leaf order
(``repro_torch.tree``); ``update(grads, state, params) -> (updates,
state)`` returns updates to add with ``apply_updates``. ``step`` is an
int32 scalar tensor and ``lr`` a float or a schedule of it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.device import f32
from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda _: torch.tensor(f32(lr))


def _step0(params):
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: f32(momentum) * m + g, state["mu"],
                          grads)
            return (tree_map(lambda m: -lr_t * m, mu),
                    {"step": step, "mu": mu})
        return (tree_map(lambda g: -lr_t * g, grads),
                {"step": step, "mu": None})

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params), "m": tree_map(torch.zeros_like,
                                                      params),
                "v": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        m = tree_map(lambda m, g: f32(b1) * m + f32(1 - b1) * g, state["m"],
                     grads)
        v = tree_map(lambda v, g: f32(b2) * v + f32(1 - b2) * g * g,
                     state["v"], grads)
        s = step.float()
        bc1 = 1 - torch.pow(torch.tensor(f32(b1)), s)
        bc2 = 1 - torch.pow(torch.tensor(f32(b2)), s)
        lr_t = lr_fn(step)

        def u(m, v, p):
            upd = -(lr_t * (m / bc1) / (torch.sqrt(v / bc2) + f32(eps)))
            if weight_decay:
                upd = upd - lr_t * f32(weight_decay) * p
            return upd

        return tree_map(u, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, in leaf order."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.square(x.float()).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp_max(f32(max_norm) / torch.clamp_min(g, f32(1e-12)),
                            1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads)
