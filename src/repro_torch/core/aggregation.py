"""PAOTA aggregation (eqs. 6, 8 and 9), torch form.

Port of the dense, raveled, single-device branch of
``repro.core.aggregation``: the params dict <-> flat vector ravel in the
reference's leaf order, the AirComp superposition of the stacked (K, d)
payload (sweep 2 of the round, ``repro_torch.kernels.ops
.superpose_normalize``, or with ``use_kernel`` the host path's
``aircomp_sum`` route), the active cohort's superposition of its
compressed (m, s) plane (``gather_superpose``), and the zero-uploader
guarded update.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.aircomp import VARSIGMA_MIN, aircomp_aggregate
from repro_torch.device import f32
from repro_torch.kernels.ops import gather_superpose, superpose_normalize


def _leaves(tree, prefix=()):
    """(path, tensor) pairs in JAX's tree_flatten order for nested dicts:
    keys sorted at every level (so the MLP ravels biases first:
    l1.b, l1.w, l2.b, l2.w, l3.b, l3.w)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(_leaves(tree[key], prefix + (key,)))
        return out
    return [(prefix, tree)]


def tree_map(fn, tree, *rest):
    """Map over the leaves of nested params dicts of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def _build(paths, values):
    tree: dict = {}
    for path, v in zip(paths, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return tree


def ravel(params) -> Tuple[torch.Tensor, Callable]:
    """Flatten a nested params dict into one (d,) vector in the reference's
    ``ravel_pytree`` order. Returns (vector, unravel); ``unravel`` maps a
    (d,) vector back to a dict of views of it."""
    leaves = _leaves(params)
    paths = [p for p, _ in leaves]
    shapes = [tuple(t.shape) for _, t in leaves]
    sizes = [t.numel() for _, t in leaves]
    vec = torch.cat([t.reshape(-1) for _, t in leaves])

    def unravel(v: torch.Tensor):
        parts = torch.split(v, sizes, dim=-1)
        lead = tuple(v.shape[:-1])
        return _build(paths, [p.reshape(lead + s)
                              for p, s in zip(parts, shapes)])

    return vec, unravel


def ravel_stacked(params) -> torch.Tensor:
    """Client-stacked params dict ((K, ...) leaves) -> (K, d) in ravel
    order: one concatenate, value-identical to raveling every row."""
    leaves = [t for _, t in _leaves(params)]
    k = leaves[0].shape[0]
    return torch.cat([t.reshape(k, -1) for t in leaves], dim=1)


def guarded_global_update(global_vec, prev_global, agg, varsigma, *,
                          delta: bool = False,
                          threshold: float = VARSIGMA_MIN):
    """The round update with the zero-uploader guard, as a device select.

    If the normalizer sits at or below the clamp (nobody uploaded) or the
    aggregate holds a NaN/Inf, both w_g and prev_global are held bit for
    bit. Returns (new_global, new_prev_global)."""
    ok = (varsigma > f32(threshold)) & torch.isfinite(agg).all()
    cand = global_vec + agg if delta else agg
    return (torch.where(ok, cand, global_vec),
            torch.where(ok, global_vec, prev_global))


def paota_aggregate_stacked(stacked: torch.Tensor, powers: torch.Tensor,
                            mask: torch.Tensor, noise: torch.Tensor,
                            use_kernel: bool = False):
    """Eq. (8) over the raveled (K, d) payload: w = (sum_k b_k p_k w_k + n)
    / sum_k b_k p_k, with the AWGN realization ``noise`` (d,) already
    scaled by sigma_n. Returns ((d,) f32 aggregate, clamped varsigma).

    ``use_kernel`` takes the reference's ``aircomp_aggregate`` route (the
    ``aircomp_sum`` kernel). Otherwise sweep 2 runs, and where the reference
    re-sums b*p for varsigma the kernel's raw sum comes back with the
    aggregate and is clamped, so no second reduction runs (an all-zero
    mask sums to exactly 0 either way)."""
    if use_kernel:
        return aircomp_aggregate(stacked, powers, mask, noise,
                                 use_kernel=True)
    agg, raw = superpose_normalize(stacked, powers, mask, noise,
                                   vs_min=VARSIGMA_MIN)
    return agg, torch.clamp_min(raw, f32(VARSIGMA_MIN))


def paota_aggregate_compressed(values: torch.Tensor, idx: torch.Tensor,
                               powers: torch.Tensor, mask: torch.Tensor,
                               noise: torch.Tensor, d: int, scale=None):
    """Eq. (8) over the (m, s) compressed cohort plane: each slot's stored
    values on its own support superpose straight into d-space
    (``repro_torch.kernels.ops.gather_superpose``), with the same (d,)
    AWGN realization the dense round takes. ``scale`` folds int8
    dequantization into the weights; varsigma sums the raw b*p and is
    clamped here, after the call. Returns ((d,) f32 aggregate, clamped
    varsigma)."""
    agg, raw = gather_superpose(values, idx, powers * mask, noise, d=d,
                                scale=scale, vs_min=VARSIGMA_MIN)
    return agg, torch.clamp_min(raw, f32(VARSIGMA_MIN))
