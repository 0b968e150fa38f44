"""Batched federation engine, torch form: M local SGD steps for all K
clients at once.

Port of ``repro.fl.engine.BatchedEngine``. The federation lives on the
device as padded (K, n_max, ...) tensors; each step gathers the (K, B)
minibatch of every client and takes ``torch.func.vmap(torch.func.grad(
loss))`` over the client axis, the reference's ``jax.vmap(jax.grad)``.
Those per-client products are plain matrix products, which XLA owns in the
reference; here torch runs them, in full f32 (TF32 off).
"""
from __future__ import annotations

from typing import List

import torch
from torch.func import grad, vmap

from repro_torch.core.aggregation import ravel_stacked, tree_map
from repro_torch.data.pipeline import ClientData, stack_federation
from repro_torch.device import f32, full_f32_matmul, resolve_device
from repro_torch.fl.client import FLClient


class BatchedEngine:
    """vmap-over-clients local SGD over a device-resident federation."""

    def __init__(self, fed: List[ClientData], loss_fn, batch_size: int = 32,
                 lr: float = 0.05, local_steps: int = 5, *, device=None):
        self.device = resolve_device(device)
        full_f32_matmul()
        self.batch_size = batch_size
        self.lr = lr
        self.local_steps = local_steps
        self.n_clients = len(fed)
        stacked = stack_federation(fed)
        self.n_samples = stacked.n_samples
        self._x = torch.as_tensor(stacked.x, device=self.device)
        self._y = torch.as_tensor(stacked.y, device=self.device).long()
        self._n_dev = torch.as_tensor(self.n_samples, device=self.device)
        self._rows = torch.arange(self.n_clients, device=self.device)[:, None]
        self._grad = vmap(grad(loss_fn))

    @classmethod
    def from_clients(cls, clients: List[FLClient], device=None):
        """Build from a homogeneous FLClient list (same hyperparameters)."""
        c0 = clients[0]
        for c in clients[1:]:
            if (c.loss_fn is not c0.loss_fn or c.batch_size != c0.batch_size
                    or c.lr != c0.lr or c.local_steps != c0.local_steps):
                raise ValueError("BatchedEngine requires homogeneous client "
                                 "hyperparameters; got a mixed federation")
        return cls([c.data for c in clients], c0.loss_fn,
                   batch_size=c0.batch_size, lr=c0.lr,
                   local_steps=c0.local_steps, device=device)

    def train_all(self, params, idx: torch.Tensor) -> torch.Tensor:
        """Every client runs M SGD steps from the broadcast ``params``
        (a params dict) on its rows of the (K, M, B) plan ``idx``.
        Returns the (K, d) raveled trained models."""
        k = self.n_clients
        p = tree_map(lambda t: t.expand((k,) + t.shape), params)
        lr = f32(self.lr)
        for m in range(idx.shape[1]):
            sel = idx[:, m]
            batch = {"x": self._x[self._rows, sel],
                     "y": self._y[self._rows, sel]}
            p = tree_map(lambda t, g: t - lr * g, p, self._grad(p, batch))
        return ravel_stacked(p)
