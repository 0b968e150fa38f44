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


def aircomp_sum_ref(stacked, bp, noise):
    """(sum_k bp_k x_k + noise) / max(sum bp, 1e-12) as f32."""
    bp64 = bp.double()
    acc = bp64 @ stacked.double()
    return ((acc + noise.double())
            / torch.clamp_min(bp64.sum(), 1e-12)).float()


def cosine_partials_ref(deltas, g):
    """(K, 2) [dot_k, ||delta_k||^2] as f32."""
    d64 = deltas.double()
    return torch.stack([d64 @ g.double(), (d64 * d64).sum(1)], 1).float()


def gather_superpose_ref(values, idx, bp, noise, d: int, scale=None,
                         vs_min: float = 1e-12):
    """((sum_k w_k scatter(v_k) + noise) / max(sum bp, vs_min), sum bp) as
    f32, with w = bp * scale rounded to f32 first, as the kernels do."""
    w = (bp if scale is None else bp * scale).double()
    acc = torch.zeros((d,), dtype=torch.float64, device=values.device)
    contrib = w[:, None] * values.double()
    acc.index_add_(0, idx.long().reshape(-1), contrib.reshape(-1))
    raw = bp.double().sum()
    agg = (acc + noise.double()) / torch.clamp_min(raw, vs_min)
    return agg.float(), raw.float()


def ssd_intra_chunk_ref(cum, b, c, xdt):
    """(y (G, Q, P) in xdt's dtype, state (G, N, P) f32, chunk_decay (G,)
    f32) of the SSD intra-chunk part, accumulated in float64."""
    q = cum.shape[1]
    c64 = cum.double()
    b64, x64 = b.double(), xdt.double()
    decay = torch.exp(torch.clamp(c64[:, :, None] - c64[:, None, :],
                                  -60.0, 0.0))
    causal = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    scores = torch.where(causal, torch.bmm(c.double(), b64.transpose(1, 2))
                         * decay, 0.0)
    tail = torch.exp(torch.clamp(c64[:, -1:] - c64, -60.0, 0.0))
    state = torch.bmm((b64 * tail[..., None]).transpose(1, 2), x64)
    return (torch.bmm(scores, x64).to(xdt.dtype), state.float(),
            torch.exp(torch.clamp(c64[:, -1], -60.0, 0.0)).float())


def swa_attention_ref(q, k, v, *, window=None, causal: bool = True):
    """(BH, T, D) in q's dtype: full-softmax attention with the causal and
    window masks, softmax scale 1/sqrt(D), fully masked rows 0, in
    float64."""
    t, s = q.shape[1], k.shape[1]
    qp = torch.arange(t, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    logits = torch.bmm(q.double(), k.double().transpose(1, 2))
    logits = logits / q.shape[-1] ** 0.5
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)   # rows with no key
    return torch.bmm(probs, v.double()).to(q.dtype)
