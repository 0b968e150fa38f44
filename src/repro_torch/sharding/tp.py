"""Intra-client tensor-parallel topology of the sharded PAOTA round.

Port of ``repro.sharding.tp``. On a ``("pod", "data", "tp")`` mesh the
client axes shard the federation while the "tp" axis shards each client's
model storage: every stacked payload leaf (pending, deltas) keeps one
trailing dim split over the TP ranks, so the model-plane bytes a rank
holds drop to about 1 / TP.

Storage-parallel, compute-replicated: the globals stay whole on every TP
rank and local training runs alike on each; only the carry writes slice
the trained rows down to the rank's block. The round's reductions follow:

  * the stats sweep runs on the TP-local blocks against the matching
    slice of the global direction and closes with one small all-reduce
    over the TP ranks; TP-replicated leaves add outside it;
  * the superposition stays one model-sized all-reduce: each TP rank
    embeds its block at its place in the full flat model vector (zeros
    elsewhere, replicated leaves masked to the lead rank), and one
    all-reduce over clients x TP sums the clients and gathers the blocks;
  * the noise is drawn at the full leaf shapes, so the realization does
    not depend on the layout.

``TPTopology`` is static: the TP axes, their extents, the rank's linear
coordinate along them (the order of the blocks of a split dim), and per params leaf (leaf order) the unstacked
trailing dim it is split along, or -1 for a replicated leaf.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.tree import build, leaves_with_paths, tree_leaves


class TPTopology(NamedTuple):
    axes: Tuple[str, ...]       # mesh axes the model storage spans
    extents: Tuple[int, ...]    # their extents
    shards: int                 # product of the extents (> 1)
    leaf_dims: Tuple[int, ...]  # per leaf: trailing dim split, or -1
    index: int                  # this rank's row-major coordinate


def tp_slice(leaf: torch.Tensor, dim: int, tp: TPTopology) -> torch.Tensor:
    """This rank's block of a full ``leaf`` along ``dim`` (divisible by
    ``tp.shards``), as a contiguous tensor."""
    size = leaf.shape[dim] // tp.shards
    return leaf.narrow(dim, tp.index * size, size).contiguous()


def tp_block(tree, tp: TPTopology, lead: int):
    """This rank's block of every split leaf of ``tree`` (replicated leaves
    as they are); ``lead`` leading dims come before the unstacked ones (1
    for client-stacked leaves, 0 for the global)."""
    paths = [p for p, _ in leaves_with_paths(tree)]
    return build(paths, [tp_slice(l, dim + lead, tp) if dim >= 0 else l
                         for l, dim in zip(tree_leaves(tree),
                                           tp.leaf_dims)])


def tp_full_shapes(stacked_leaves, tp: TPTopology):
    """The full-model (K, ...) shapes of TP-local stacked leaves: each
    split leaf's dim scaled back up by ``tp.shards``."""
    out = []
    for leaf, dim in zip(stacked_leaves, tp.leaf_dims):
        shape = list(leaf.shape)
        if dim >= 0:
            shape[dim + 1] *= tp.shards
        out.append(tuple(shape))
    return out
