"""Federated client data, stacked for batched local training, torch form.

Port of ``repro.data.pipeline``: ``ClientData`` (one client's dataset and
its epoch-shuffled minibatch cursor), ``build_federation`` and
``stack_federation`` (pad the ragged per-client datasets into
(K, n_max, ...) arrays) are numpy copies of the reference, bit for bit: the
host-mode servers plan their minibatches from the epoch cursors.
``counter_batch_plan`` replaces the reference's threefry plan: the
(K, M, B) minibatch indices of one round come from one ``torch.Generator``
keyed on (seed, round, TAG_BATCH), and row k draws i.i.d. uniform from
range(n_k), so client k's plan is a pure function of (seed, round, k).
Like the reference it samples with replacement and never selects a
padding row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core.scheduler import TAG_BATCH, round_tag_generator


class ClientData:
    """One client's local dataset D_k with an epoch-shuffled batch cursor.
    The permutation of epoch e is a pure function of (seed, client id, e);
    the cursor is host state that successive broadcasts resume."""

    def __init__(self, x: np.ndarray, y: np.ndarray, client_id: int,
                 seed: int = 0):
        self.x, self.y = x, y
        self.client_id = client_id
        self._seed = seed
        self._epoch = 0
        self._order_cache = (-1, None)   # (epoch, permutation)

    def __len__(self):
        return len(self.y)

    def _epoch_order(self) -> np.ndarray:
        if self._order_cache[0] != self._epoch:
            rng = np.random.default_rng(
                (self._seed, self.client_id, self._epoch))
            self._order_cache = (self._epoch, rng.permutation(len(self.y)))
        return self._order_cache[1]

    def batch_indices(self, batch_size: int, n_batches: int):
        """Yield ``n_batches`` index arrays into (x, y), moving to a freshly
        shuffled epoch when the current one has fewer than ``batch_size``
        rows left (the rest of that epoch is skipped, as in the
        reference)."""
        order = self._epoch_order()
        i = 0
        for _ in range(n_batches):
            if i + batch_size > len(order):
                self._epoch += 1
                order = self._epoch_order()
                i = 0
            sel = order[i:i + batch_size]
            i += batch_size
            yield sel

    def batches(self, batch_size: int, n_batches: int):
        """Yield ``n_batches`` minibatches {"x", "y"}."""
        for sel in self.batch_indices(batch_size, n_batches):
            yield {"x": self.x[sel], "y": self.y[sel]}


def build_federation(x, y, parts, seed: int = 0):
    return [ClientData(x[p], y[p], k, seed) for k, p in enumerate(parts)]


@dataclass
class StackedFederation:
    """Per-client datasets padded and stacked into (K, n_max, ...) arrays;
    rows beyond ``n_samples[k]`` are zero padding."""
    x: np.ndarray            # (K, n_max, ...) float32 features
    y: np.ndarray            # (K, n_max) int32 labels
    n_samples: np.ndarray    # (K,) int64 true per-client sizes


def stack_federation(fed: List[ClientData]) -> StackedFederation:
    """Pad and stack per-client (ragged) datasets into (K, n_max, ...)."""
    if not fed:
        raise ValueError("empty federation")
    sizes = np.array([len(c) for c in fed], dtype=np.int64)
    n_max = int(sizes.max())
    x0 = np.asarray(fed[0].x)
    x_dtype = np.float32 if np.issubdtype(x0.dtype, np.floating) else x0.dtype
    x = np.zeros((len(fed), n_max) + x0.shape[1:], x_dtype)
    y = np.zeros((len(fed), n_max), np.int32)
    for k, c in enumerate(fed):
        x[k, :len(c)] = c.x
        y[k, :len(c)] = c.y
    return StackedFederation(x=x, y=y, n_samples=sizes)


def counter_batch_plan(base_seed: int, round_idx: int,
                       n_samples: torch.Tensor, n_batches: int,
                       batch_size: int, batch_sizes=None) -> torch.Tensor:
    """(K, M, B) int64 minibatch indices for broadcast round ``round_idx``:
    client k draws i.i.d. uniform from range(n_samples[k]), on
    ``n_samples``'s device.

    ``batch_sizes``: optional (K,) per-client batch sizes b_k <= B. The
    plan keeps its (K, M, B) shape and column j of client k repeats draw
    j mod b_k (the reference's cyclic fold), so the mean gradient over a
    row is exactly the b_k-minibatch gradient when b_k divides B."""
    dev = n_samples.device
    gen = round_tag_generator(base_seed, round_idx, TAG_BATCH, dev)
    k = n_samples.shape[0]
    u = torch.rand((k, n_batches, batch_size), generator=gen, device=dev,
                   dtype=torch.float64)
    n = n_samples.to(torch.float64)[:, None, None]
    idx = (u * n).to(torch.int64)          # floor: u < 1, so idx < n_k
    idx = torch.minimum(idx, n_samples[:, None, None] - 1)
    if batch_sizes is None:
        return idx
    cols = torch.arange(batch_size, device=dev)
    fold = torch.remainder(cols[None, :], batch_sizes.long()[:, None])
    return torch.gather(idx, 2, fold[:, None, :].expand(k, n_batches,
                                                        batch_size))
