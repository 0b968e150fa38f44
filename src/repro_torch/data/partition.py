"""Non-IID federated partitioner, Section IV-A (numpy only).

A copy of ``repro.data.partition`` and its size ladders: in
``partition_noniid`` each client draws |D_k| from the ladder and at most
five of the ten classes (``PAPER_SIZES`` is the published ladder,
``FAST_SIZES`` the scaled-down one); ``partition_dirichlet`` is the
Dirichlet label-skew partitioner of the ablation, and
``heterogeneity_stats`` describes a partition. Same seed, same partition
as the reference, bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

PAPER_SIZES = (300, 600, 900, 1200, 1500)
FAST_SIZES = (60, 120, 180, 240, 300)


def partition_noniid(y: np.ndarray, n_clients: int = 100,
                     max_classes_per_client: int = 5,
                     sizes: Optional[Sequence[int]] = None,
                     paper_scale: bool = False,
                     seed: int = 0) -> List[np.ndarray]:
    """Returns per-client index arrays into the training set.

    Each client: |D_k| drawn uniformly from the size ladder; classes drawn
    without replacement (<= max_classes_per_client); samples drawn (with
    replacement if a class pool is exhausted) from those classes only.
    """
    rng = np.random.default_rng(seed)
    sizes = tuple(sizes) if sizes is not None else (
        PAPER_SIZES if paper_scale else FAST_SIZES)
    classes = np.unique(y)
    by_class = {int(c): np.where(y == c)[0] for c in classes}
    out = []
    for _ in range(n_clients):
        d_k = int(rng.choice(sizes))
        n_cls = int(rng.integers(1, max_classes_per_client + 1))
        cls = rng.choice(classes, size=n_cls, replace=False)
        per = np.array_split(np.arange(d_k), n_cls)
        idx = []
        for c, chunk in zip(cls, per):
            pool = by_class[int(c)]
            take = rng.choice(pool, size=len(chunk),
                              replace=len(chunk) > len(pool))
            idx.append(take)
        out.append(np.concatenate(idx))
    return out


def partition_dirichlet(y: np.ndarray, n_clients: int, alpha: float = 0.3,
                        seed: int = 0) -> List[np.ndarray]:
    """Dirichlet(alpha) label-skew partitioner (ablation, beyond-paper).
    A client that draws no sample of any class is left empty."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    idx_out = [[] for _ in range(n_clients)]
    for c in classes:
        pool = rng.permutation(np.where(y == c)[0])
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(pool)).astype(int)[:-1]
        for k, part in enumerate(np.split(pool, cuts)):
            idx_out[k].append(part)
    return [np.concatenate(p) if p else np.array([], np.int64)
            for p in idx_out]


def heterogeneity_stats(parts: List[np.ndarray], y: np.ndarray) -> dict:
    """Client sizes and classes per client of a partition."""
    sizes = np.array([len(p) for p in parts])
    n_cls = np.array([len(np.unique(y[p])) if len(p) else 0 for p in parts])
    return {"sizes_min": int(sizes.min()), "sizes_max": int(sizes.max()),
            "sizes_mean": float(sizes.mean()),
            "classes_mean": float(n_cls.mean()),
            "classes_max": int(n_cls.max())}
