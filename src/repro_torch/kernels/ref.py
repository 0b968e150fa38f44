"""Oracles for the port's kernels, in plain torch.

Written independently of the twins in ``round_stats`` / ``aircomp_sum``:
the oracles accumulate in float64 and round once to float32, so a test
holding a twin or a kernel against them checks the arithmetic, not a copy
of it.
"""
from __future__ import annotations

import torch


def round_stats_ref(deltas, g, payload=None):
    """(stats (K, 2|3), gn2): [dot_k, ||delta_k||^2 (, ||payload_k||^2)]
    and ||g||^2, as f32."""
    d64 = deltas.double()
    g64 = g.double()
    cols = [d64 @ g64, (d64 * d64).sum(1)]
    if payload is not None:
        p64 = payload.double()
        cols.append((p64 * p64).sum(1))
    return torch.stack(cols, 1).float(), (g64 * g64).sum().float()


def superpose_normalize_ref(stacked, powers, mask, noise,
                            vs_min: float = 1e-12):
    """((sum_k b_k p_k x_k + noise) / max(sum bp, vs_min), sum bp) as f32,
    with bp = p * mask rounded to f32 first, as the kernels do."""
    bp = (powers.float() * mask.float()).double()
    raw = bp.sum()
    acc = bp @ stacked.double()
    agg = (acc + noise.double()) / torch.clamp_min(raw, vs_min)
    return agg.float(), raw.float()
