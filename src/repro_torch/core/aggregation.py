"""PAOTA aggregation (eqs. 6, 8 and 9), torch form.

Port of the single-device branches of ``repro.core.aggregation``: the
params dict <-> flat vector ravel in the reference's leaf order, the
AirComp superposition of the stacked payload (sweep 2 of the round,
``repro_torch.kernels.ops.superpose_normalize``, once on a raveled (K, d)
plane or once per leaf of a params dict of (K, ...) leaves, with one flat
AWGN realization split across the leaves; with ``use_kernel`` the host
path's ``aircomp_sum`` route), the active cohort's superposition of its
compressed (m, s) plane (``gather_superpose``), and the zero-uploader
guarded update.

Under the sharded round (``reducer``: ``repro_torch.launch.collectives
.Reducer``) the superposition splits in two halves around one
all-reduce: ``paota_partial_stacked`` (the local flat (d_total + 1,) f32
partial, the varsigma partial appended; ``ops.aircomp_partial``, one
launch a leaf) and ``paota_finalize_stacked`` (the noise once, after the
collective, then the division). ``paota_allreduce`` and
``exact_average`` are the reference's per-leaf collective aggregations
for one payload a rank.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from repro_torch.core.aircomp import VARSIGMA_MIN, aircomp_aggregate
from repro_torch.device import f32
from repro_torch.kernels.aircomp_sum import (aircomp_finalize_tree,
                                             aircomp_partial_tree,
                                             aircomp_partial_tree_tp)
from repro_torch.kernels.ops import gather_superpose, superpose_normalize
from repro_torch.tree import (build, leaf2d, leaves_with_paths, tree_leaves,
                              tree_map)


def ravel(params) -> Tuple[torch.Tensor, Callable]:
    """Flatten a nested params dict into one (d,) vector in the reference's
    ``ravel_pytree`` order. Returns (vector, unravel); ``unravel`` maps a
    (d,) vector back to a dict of views of it."""
    leaves = leaves_with_paths(params)
    paths = [p for p, _ in leaves]
    shapes = [tuple(t.shape) for _, t in leaves]
    sizes = [t.numel() for _, t in leaves]
    vec = torch.cat([t.reshape(-1) for _, t in leaves])

    def unravel(v: torch.Tensor):
        parts = torch.split(v, sizes, dim=-1)
        lead = tuple(v.shape[:-1])
        return build(paths, [p.reshape(lead + s)
                              for p, s in zip(parts, shapes)])

    return vec, unravel


def ravel_stacked(params) -> torch.Tensor:
    """Client-stacked params dict ((K, ...) leaves) -> (K, d) in ravel
    order: one concatenate, value-identical to raveling every row."""
    leaves = tree_leaves(params)
    k = leaves[0].shape[0]
    return torch.cat([t.reshape(k, -1) for t in leaves], dim=1)


def guarded_global_update(global_vec, prev_global, agg, varsigma, *,
                          delta: bool = False,
                          threshold: float = VARSIGMA_MIN):
    """The round update with the zero-uploader guard, as a device select.

    If the normalizer sits at or below the clamp (nobody uploaded) or the
    aggregate holds a NaN/Inf, both w_g and prev_global are held bit for
    bit, every leaf of them for a params dict. Returns (new_global,
    new_prev_global)."""
    ok = varsigma > f32(threshold)
    for leaf in tree_leaves(agg):
        ok = ok & torch.isfinite(leaf).all()
    return (tree_map(lambda g, a: torch.where(ok, g + a if delta else a, g),
                     global_vec, agg),
            tree_map(lambda g, pg: torch.where(ok, g, pg), global_vec,
                     prev_global))


def stacked_tree_noise(noise: torch.Tensor, stacked_leaves) -> list:
    """One eq.-6 AWGN realization for the whole model: the flat (d,) draw
    split per leaf in leaf order (leaf i takes the next prod(shape[1:])
    entries, shaped to its trailing dims), so a params dict and its
    raveled plane consume the same realization."""
    out, off = [], 0
    for leaf in stacked_leaves:
        size = leaf[0].numel()
        out.append(noise[off:off + size].reshape(leaf.shape[1:]))
        off += size
    return out


def paota_aggregate_stacked(stacked, powers: torch.Tensor,
                            mask: torch.Tensor, noise,
                            use_kernel: bool = False, reducer=None,
                            tp=None):
    """Eq. (8) over the stacked payload: w = (sum_k b_k p_k w_k + n) /
    sum_k b_k p_k, with the AWGN realization ``noise`` (d,) already scaled
    by sigma_n. Returns (aggregate, clamped varsigma): a params dict of
    f32 leaves for a dict of (K, ...) leaves (f32 or bf16), which sweep 2
    takes one leaf at a time on its slice of the flat noise
    (``stacked_tree_noise``), or a (d,) f32 vector for a raveled (K, d)
    plane, the one-leaf tree.

    ``noise=None`` is the noiseless channel: each leaf is the
    f32-accumulating b*p contraction over the clamped varsigma, and no
    AWGN is added (the fused round passes it when sigma_n = 0, where the
    reference skips the draw). ``use_kernel`` takes the reference's
    ``aircomp_aggregate`` route for a raveled plane (the ``aircomp_sum``
    kernel).
    Otherwise sweep 2 runs, and where the reference re-sums b*p for
    varsigma the kernel's raw sum comes back with the aggregate and is
    clamped, so no second reduction runs (an all-zero mask sums to exactly
    0 either way).

    ``reducer``: the (K, ...) rows are this rank's clients; the local
    partial goes through ONE all-reduce over the reducer's axes (and
    ``tp.axes`` where ``tp``, a ``TPTopology``, says the leaves are
    TP-local blocks, which embed at their place in the full leaves), and
    the noise (drawn at the full shapes) joins once, after it. The
    aggregate leaves come back full-shape."""
    if reducer is not None:
        leaves = tree_leaves(stacked)
        flat = paota_partial_stacked(stacked, powers, mask, tp=tp)
        axes = reducer.axes + (tp.axes if tp is not None else ())
        flat = reducer.sum(flat, axes=axes, tag="superpose")
        if tp is not None:
            from repro_torch.sharding.tp import tp_full_shapes
            shapes = tp_full_shapes(leaves, tp)
        else:
            shapes = [tuple(l.shape) for l in leaves]
        return paota_finalize_stacked(flat, stacked, noise, shapes=shapes)
    if use_kernel and isinstance(stacked, torch.Tensor):
        return aircomp_aggregate(stacked, powers, mask, noise,
                                 use_kernel=True)
    leaves = tree_leaves(stacked)
    if noise is None:
        bp = powers * mask
        varsigma = torch.clamp_min(bp.sum(), f32(VARSIGMA_MIN))
        agg = [(bp @ leaf2d(l).float() / varsigma).reshape(l.shape[1:])
               for l in leaves]
        return _like(stacked, agg), varsigma
    agg, raw = [], None
    for leaf, nz in zip(leaves, stacked_tree_noise(noise, leaves)):
        out, raw = superpose_normalize(leaf2d(leaf), powers, mask,
                                       nz.reshape(-1), vs_min=VARSIGMA_MIN)
        agg.append(out.reshape(leaf.shape[1:]))
    return _like(stacked, agg), torch.clamp_min(raw, f32(VARSIGMA_MIN))


def _like(tree, leaves):
    """``leaves`` (in leaf order) in the structure of ``tree``."""
    if not isinstance(tree, dict):
        return leaves[0]
    return build([p for p, _ in leaves_with_paths(tree)], leaves)


def paota_aggregate_compressed(values: torch.Tensor, idx: torch.Tensor,
                               powers: torch.Tensor, mask: torch.Tensor,
                               noise: torch.Tensor, d: int, scale=None):
    """Eq. (8) over the (m, s) compressed cohort plane: each slot's stored
    values on its own support superpose straight into d-space
    (``repro_torch.kernels.ops.gather_superpose``), with the same (d,)
    AWGN realization the dense round takes. ``scale`` folds int8
    dequantization into the weights; varsigma sums the raw b*p and is
    clamped here, after the call. ``noise=None`` (the noiseless channel)
    superposes zeros, as the reference does. Returns ((d,) f32 aggregate,
    clamped varsigma)."""
    if noise is None:
        noise = torch.zeros((d,), dtype=torch.float32, device=values.device)
    agg, raw = gather_superpose(values, idx, powers * mask, noise, d=d,
                                scale=scale, vs_min=VARSIGMA_MIN)
    return agg, torch.clamp_min(raw, f32(VARSIGMA_MIN))


def paota_partial_stacked(stacked, powers: torch.Tensor, mask: torch.Tensor,
                          reducer=None, tp=None) -> torch.Tensor:
    """The half of eq. (8) before the collective: this rank's flat
    (d_total + 1,) f32 superposition partial (each leaf's b*p-weighted
    sum, the sum of b*p appended), no noise, no division. ``reducer``
    reduces it over its axes (the grouped round's intra-pod sum); ``tp``
    embeds TP-local blocks in the full flat vector. Masked rows add exact
    zeros, so a pod with no uploader holds an exactly zero partial."""
    leaves = tree_leaves(stacked)
    bp = powers * mask
    if tp is not None:
        flat = aircomp_partial_tree_tp(leaves, bp, tp)
    else:
        flat = aircomp_partial_tree(leaves, bp)
    if reducer is not None:
        flat = reducer.sum(flat, tag="superpose")
    return flat


def paota_finalize_stacked(flat: torch.Tensor, stacked, noise,
                           reducer=None, shapes=None):
    """Finish eq. (8) from a flat partial: ``reducer`` sums it over its
    axes first (the one cross-pod all-reduce of a grouped window), then
    the (d,) ``noise`` (None: noiseless) joins once, split per leaf, and
    the clamped varsigma divides. ``stacked`` gives the structure, and
    the leaf shapes unless ``shapes`` (full (K, ...) shapes) is given.
    Returns (aggregate, varsigma) as ``paota_aggregate_stacked``."""
    if reducer is not None:
        flat = reducer.sum(flat, tag="superpose")
    leaves = tree_leaves(stacked)
    if shapes is None:
        shapes = [tuple(l.shape) for l in leaves]
    noise_leaves = None
    if noise is not None:
        noise_leaves, off = [], 0
        for shape in shapes:
            size = math.prod(shape[1:])
            noise_leaves.append(noise[off:off + size])
            off += size
    agg, varsigma = aircomp_finalize_tree(flat, shapes, noise_leaves,
                                          VARSIGMA_MIN)
    return _like(stacked, agg), varsigma


def paota_allreduce(local_payload, power: torch.Tensor, ready: torch.Tensor,
                    reducer, noise=None):
    """One payload per rank (a tree, with a scalar power p_k and ready bit
    b_k): the PAOTA aggregate (sum b_k p_k w_k + n) / sum b_k p_k, the
    same on every rank. ``noise`` is a tree like the payload, the same
    realization on every rank (eq. 6 adds it once, at the server), or
    None. One all-reduce for varsigma and one a leaf, as the
    reference's."""
    bp = (power * ready).reshape(1).float()
    varsigma = torch.clamp_min(reducer.sum(bp.clone(), tag="varsigma")[0],
                               f32(1e-12))
    nz = (tree_map(lambda x: None, local_payload) if noise is None
          else noise)

    def agg(x, n):
        s = reducer.sum((x * bp.to(x.dtype)).contiguous(), tag="leaf")
        if n is not None:
            s = s + n
        return s / varsigma.to(x.dtype)

    return tree_map(agg, local_payload, nz)


def exact_average(local_payload, weight: torch.Tensor, reducer):
    """Lossless weighted mean over the ranks (Local SGD's aggregation)."""
    w = weight.reshape(1).float()
    wsum = reducer.sum(w.clone(), tag="weight")[0]

    def agg(x):
        return (reducer.sum((x * w.to(x.dtype)).contiguous(), tag="leaf")
                / wsum.to(x.dtype))

    return tree_map(agg, local_payload)
