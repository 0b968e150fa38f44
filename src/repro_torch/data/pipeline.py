"""Federated client data, stacked for batched local training, torch form.

Port of ``repro.data.pipeline``: ``ClientData`` (one client's dataset),
``build_federation`` and ``stack_federation`` (pad the ragged per-client
datasets into (K, n_max, ...) arrays) are numpy, as in the reference.
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
    """One client's local dataset D_k. The port plans minibatches with
    counter plans only (``counter_batch_plan``), so the reference's
    epoch-cursor iterator has no counterpart here."""

    def __init__(self, x: np.ndarray, y: np.ndarray, client_id: int):
        self.x, self.y = x, y
        self.client_id = client_id

    def __len__(self):
        return len(self.y)


def build_federation(x, y, parts):
    return [ClientData(x[p], y[p], k) for k, p in enumerate(parts)]


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
                       batch_size: int) -> torch.Tensor:
    """(K, M, B) int64 minibatch indices for broadcast round ``round_idx``:
    client k draws i.i.d. uniform from range(n_samples[k]), on
    ``n_samples``'s device."""
    dev = n_samples.device
    gen = round_tag_generator(base_seed, round_idx, TAG_BATCH, dev)
    k = n_samples.shape[0]
    u = torch.rand((k, n_batches, batch_size), generator=gen, device=dev,
                   dtype=torch.float64)
    n = n_samples.to(torch.float64)[:, None, None]
    idx = (u * n).to(torch.int64)          # floor: u < 1, so idx < n_k
    return torch.minimum(idx, n_samples[:, None, None] - 1)
