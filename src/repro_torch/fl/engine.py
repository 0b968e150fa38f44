"""Batched federation engine, torch form: M local SGD steps for all K
clients at once.

Port of ``repro.fl.engine.BatchedEngine``. The federation lives on the
device as padded (K, n_max, ...) tensors; each step gathers the (K, B)
minibatch of every client and takes ``torch.func.vmap(torch.func.grad(
loss))`` over the client axis, the reference's ``jax.vmap(jax.grad)``.
Those per-client products are plain matrix products, which XLA owns in the
reference; here torch runs them, in full f32 (TF32 off).

The host-path servers train through ``local_train_full`` /
``local_train``: minibatch plans come from the clients' numpy epoch
cursors (zero rows for clients outside the broadcast), or, once
``enable_counter_plan`` is set, from a counter plan keyed on the broadcast
round. The reference's ``LegacyEngine`` (a per-client loop) is not ported:
``make_engine(kind="legacy")`` refuses it by name.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
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
        self.fed = fed          # epoch cursors (host-mode plans) live here
        self.loss_fn = loss_fn
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
        self._idx = np.zeros((self.n_clients, local_steps, batch_size),
                             np.int64)
        self.plan = "host"
        self._plan_fn = None
        self._steps_k = None
        self._batch_k = None

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

    def set_heterogeneity(self, steps_k=None, batch_k=None) -> None:
        """Install per-client (K,) hyperparameter heterogeneity: local-step
        counts (1 <= steps_k <= local_steps; plan rows past a client's
        count take a zero step size, so ``p - 0 * g == p`` bit for bit)
        and/or batch sizes (1 <= batch_k <= batch_size; the counter plan
        repeats a client's first b_k draws across the row, which the draw
        source applies). None leaves a dimension homogeneous."""
        def check(name, v, hi):
            if v is None:
                return None
            v = torch.as_tensor(v, device=self.device).to(torch.int32)
            if tuple(v.shape) != (self.n_clients,):
                raise ValueError(f"{name} shape {tuple(v.shape)} != "
                                 f"({self.n_clients},)")
            lo_v, hi_v = int(v.min()), int(v.max())
            if lo_v < 1 or hi_v > hi:
                raise ValueError(f"{name} must lie in [1, {hi}]; got "
                                 f"[{lo_v}, {hi_v}]")
            return v
        self._steps_k = check("steps_k", steps_k, self.local_steps)
        self._batch_k = check("batch_k", batch_k, self.batch_size)

    def steps_for(self, client_ids=None):
        """The (K,) step counts gathered at ``client_ids`` (None: all
        rows), or None when homogeneous."""
        if self._steps_k is None or client_ids is None:
            return self._steps_k
        return self._steps_k[client_ids.long()]

    def train_all(self, params, idx: torch.Tensor) -> torch.Tensor:
        """Every client runs M SGD steps from the broadcast ``params``
        (a params dict) on its rows of the (K, M, B) plan ``idx``.
        Returns the (K, d) raveled trained models."""
        return ravel_stacked(self.train_all_tree(params, idx))

    def train_rows(self, params, idx: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
        """The active cohort's twin of ``train_all``: only the clients
        ``ids`` ((m,) global ids) train, on their (m, M, B) rows of the
        broadcast plan and with their own step counts. Returns the (m, d)
        trained rows; a client's row equals its ``train_all`` row."""
        return ravel_stacked(self.train_rows_tree(params, idx, ids))

    def train_all_tree(self, params, idx: torch.Tensor) -> dict:
        """``train_all`` with the trained models as a client-stacked params
        dict ((K, ...) leaves, one contiguous tensor each), the form the
        pytree round carries (the reference's ``_train_all_tree``). The
        same SGD ops: only the final ravel is left out."""
        return self._train(params, idx, self._rows, self._steps_k)

    def train_rows_tree(self, params, idx: torch.Tensor,
                        ids: torch.Tensor) -> dict:
        """``train_rows`` with the trained rows as a stacked params dict of
        (m, ...) leaves."""
        return self._train(params, idx, ids.long()[:, None],
                           self.steps_for(ids))

    def _train(self, params, idx, rows, n_steps):
        n = rows.shape[0]
        p = tree_map(lambda t: t.expand((n,) + t.shape), params)
        lr = f32(self.lr)
        for m in range(idx.shape[1]):
            sel = idx[:, m]
            batch = {"x": self._x[rows, sel], "y": self._y[rows, sel]}
            if n_steps is None:
                step = lr
            else:
                # an exact 0.0 past a client's step count: p - 0 * g == p
                step = (lr * (m < n_steps).float()).reshape(n, 1)
            p = tree_map(lambda t, g: t - _bcast(step, t) * g, p,
                         self._grad(p, batch))
        return p

    def enable_counter_plan(self, plan_fn: Callable[[int], torch.Tensor]):
        """Plan every broadcast with ``plan_fn(round)`` ((K, M, B) indices
        on this engine's device, e.g. ``CounterDraws.batch_plan``) instead
        of the epoch cursors, which are then no longer consumed."""
        self.plan = "counter"
        self._plan_fn = plan_fn

    def _broadcast_plans(self, ids, round_idx):
        """(K, M, B) plans of a broadcast to ``ids``: the counter plan of
        ``round_idx``, or the epoch-cursor plans (zero rows for clients
        outside ``ids``, whose cursors do not move)."""
        if self.plan == "counter":
            if round_idx is None:
                raise ValueError("counter-plan engine needs the broadcast "
                                 "round index")
            return self._plan_fn(int(round_idx))
        if int(self.n_samples.min()) < self.batch_size:
            raise ValueError(
                f"host epoch-cursor plans need n_k >= batch_size for "
                f"fixed-shape minibatches (min n_k="
                f"{int(self.n_samples.min())}, batch_size="
                f"{self.batch_size}); use counter plans "
                f"(enable_counter_plan)")
        self._idx[:] = 0
        for k in ids:
            self._idx[k] = np.stack(list(
                self.fed[k].batch_indices(self.batch_size,
                                          self.local_steps)))
        return torch.as_tensor(self._idx, device=self.device)

    def local_train_full(self, params, ids: Sequence[int],
                         round_idx=None) -> torch.Tensor:
        """Train from ``params`` with every client's row of the broadcast
        plan: the (K, d) stack, whose rows outside ``ids`` are untrained
        garbage the caller must mask."""
        ids = np.asarray(ids, np.int64)
        return self.train_all(params, self._broadcast_plans(ids, round_idx))

    def local_train(self, params, ids: Sequence[int],
                    round_idx=None) -> torch.Tensor:
        """The (len(ids), d) trained rows of ``ids``, in ``ids`` order."""
        ids = np.asarray(ids, np.int64)
        flat = self.local_train_full(params, ids, round_idx=round_idx)
        return flat[torch.as_tensor(ids, device=flat.device)]


def _bcast(step, t):
    """A Python step size as is, or an (n, 1) per-row one shaped to
    broadcast against the (n, ...) leaf ``t``."""
    if isinstance(step, float):
        return step
    return step.reshape((t.shape[0],) + (1,) * (t.dim() - 1))


def make_engine(clients, kind: str = "batched", device=None):
    """An engine for ``clients``: a ``BatchedEngine`` as given, or one
    built from a list of FLClient."""
    if isinstance(clients, BatchedEngine):
        return clients
    if kind == "batched":
        return BatchedEngine.from_clients(list(clients), device=device)
    if kind == "legacy":
        raise NotImplementedError(
            "engine='legacy' selects the reference's per-client loop, which "
            "the port does not have; the ported engine is engine='batched'")
    raise ValueError(f"unknown engine kind: {kind!r} (expected 'batched')")
