"""The port's kernel seam: dispatch by the tensors' device, and nothing else.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain-torch twin. There is no environment switch and
no fallback from a failed launch to the twin.
"""
from __future__ import annotations

import torch

from repro_torch.device import f32
from repro_torch.kernels import aircomp_sum as _ac
from repro_torch.kernels import cosine_sim as _cs
from repro_torch.kernels import gather_superpose as _gs
from repro_torch.kernels import round_stats as _rs
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import swa_attention as _swa
from repro_torch.tree import leaf2d, tree_leaves


def _route(device, what: str) -> bool:
    """True for the kernel, False for the twin; raise elsewhere."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or twin for device {device}")


def round_stats(deltas, g, payload=None):
    """Fused eq.-25 stats in one sweep: ``(dots, dn2, pn2 | None, gn2)`` —
    (K,) f32 vectors and an f32 scalar. ``deltas`` is a params dict of
    (K, ...) leaves (f32 or bf16) with ``g`` (and ``payload``) of the same
    structure, or the raveled (K, D) plane, the one-leaf tree. Every leaf
    is viewed as (K, prod(trailing)) and swept on its own, the 10-wide
    bias leaves too, and the stats are summed across leaves in leaf order
    (the reference's per-leaf route, ``repro.kernels.ops.round_stats``)."""
    d_leaves = tree_leaves(deltas)
    p_leaves = (tree_leaves(payload) if payload is not None
                else [None] * len(d_leaves))
    fn = (_rs.round_stats_cuda if _route(d_leaves[0].device, "round_stats")
          else _rs.round_stats_plain)
    dots = dn2 = pn2 = gn2 = None
    for dl, pl, gl in zip(d_leaves, p_leaves, tree_leaves(g)):
        stats, g2 = fn(leaf2d(dl), gl.reshape(-1),
                       None if pl is None else leaf2d(pl))
        if dots is None:
            dots, dn2, gn2 = stats[:, 0], stats[:, 1], g2
            pn2 = None if pl is None else stats[:, 2]
        else:
            dots, dn2, gn2 = dots + stats[:, 0], dn2 + stats[:, 1], gn2 + g2
            if pl is not None:
                pn2 = pn2 + stats[:, 2]
    return dots, dn2, pn2, gn2


def round_stats_tp(deltas, g, payload, tp, reducer):
    """``round_stats`` over TP-local blocks (the reference's
    ``round_stats_tp``): the stacked leaves hold this rank's block of each
    split leaf while ``g`` is whole, so g is sliced to the block, the
    sweep (``round_stats``, one launch a leaf) runs over the split and the
    replicated leaves apart, and one packed ``[dots | dn2 (| pn2) | gn2]``
    all-reduce over ``tp.axes`` closes the split group; the replicated
    leaves add after it, so they count once."""
    from repro_torch.sharding.tp import tp_slice
    d_leaves = tree_leaves(deltas)
    g_leaves = tree_leaves(g)
    have_p = payload is not None
    p_leaves = tree_leaves(payload) if have_p else [None] * len(d_leaves)
    k = d_leaves[0].shape[0]
    sh, rep = ([], [], []), ([], [], [])
    for dl, gl, pl, dim in zip(d_leaves, g_leaves, p_leaves, tp.leaf_dims):
        dst = sh if dim >= 0 else rep
        dst[0].append(dl)
        dst[1].append(tp_slice(gl, dim, tp) if dim >= 0 else gl)
        dst[2].append(pl)

    def run(group):
        def tree(leaves):          # a list as a dict tree, in list order
            return {f"{i:06d}": l for i, l in enumerate(leaves)}
        return round_stats(tree(group[0]), tree(group[1]),
                           tree(group[2]) if have_p else None)

    if sh[0]:
        dots, dn2, pn2, gn2 = run(sh)
    else:
        dev = d_leaves[0].device
        dots = dn2 = torch.zeros((k,), dtype=torch.float32, device=dev)
        pn2 = dots if have_p else None
        gn2 = torch.zeros((), dtype=torch.float32, device=dev)
    parts = [dots, dn2] + ([pn2] if have_p else []) + [gn2.reshape(1)]
    flat = reducer.sum(torch.cat(parts), axes=tp.axes, tag="stats_tp")
    dots, dn2 = flat[:k], flat[k:2 * k]
    if have_p:
        pn2 = flat[2 * k:3 * k]
    gn2 = flat[-1]
    if rep[0]:
        r_dots, r_dn2, r_pn2, r_gn2 = run(rep)
        dots, dn2, gn2 = dots + r_dots, dn2 + r_dn2, gn2 + r_gn2
        if have_p:
            pn2 = pn2 + r_pn2
    return dots, dn2, (pn2 if have_p else None), gn2


def aircomp_partial(stacked, bp, out, offset: int = 0, *, seg=None,
                    pitch=None, write_varsigma: bool = True):
    """The local superposition partial of a (K, D) payload into the flat
    f32 ``out`` at ``offset`` (``aircomp_sum.aircomp_partial_*``: column j
    at offset + (j // seg) * pitch + j % seg, the raw sum of bp into the
    last slot when ``write_varsigma``); returns ``out``."""
    fn = (_ac.aircomp_partial_cuda
          if _route(stacked.device, "aircomp_partial")
          else _ac.aircomp_partial_plain)
    return fn(stacked, bp, out, offset, seg=seg, pitch=pitch,
              write_varsigma=write_varsigma)


def superpose_normalize(stacked, powers, mask, noise, vs_min: float = 1e-12):
    """Fused eqs. (6)+(8) for the raveled (K, D) payload:
    ``(agg (D,) f32, raw varsigma f32 scalar)``."""
    fn = (_ac.superpose_normalize_cuda
          if _route(stacked.device, "superpose_normalize")
          else _ac.superpose_normalize_plain)
    return fn(stacked, powers, mask, noise, vs_min=vs_min)


def aircomp_sum(stacked, bp, noise):
    """(sum_k bp_k x_k + noise) / max(sum_k bp_k, 1e-12) over the raveled
    (K, D) payload with bp already masked: the (D,) f32 aggregate."""
    fn = (_ac.aircomp_sum_cuda if _route(stacked.device, "aircomp_sum")
          else _ac.aircomp_sum_plain)
    return fn(stacked, bp, noise)


def cosine_sim(deltas, g, eps: float = 1e-12):
    """Per-client cos(dw_k, g) of a (K, D) plane, finished as the
    reference's kernel route finishes it (``repro.kernels.ops.cosine_sim``:
    both norms clamped at eps, and the product of the norms too)."""
    fn = (_cs.cosine_partials_cuda if _route(deltas.device, "cosine_sim")
          else _cs.cosine_partials_plain)
    parts = fn(deltas, g)
    eps = f32(eps)
    gn = torch.sqrt(torch.clamp_min((g * g).sum(), eps))
    return parts[:, 0] / torch.clamp_min(
        torch.sqrt(torch.clamp_min(parts[:, 1], eps)) * gn, eps)


def gather_superpose(values, idx, bp, noise, *, d: int, scale=None,
                     vs_min: float = 1e-12):
    """AirComp over the (m, s) compressed cohort plane: ``(agg (d,) f32,
    raw varsigma f32 scalar)``. ``scale`` folds int8 dequantization into
    the weights; varsigma is the raw sum of bp."""
    fn = (_gs.gather_superpose_cuda
          if _route(values.device, "gather_superpose")
          else _gs.gather_superpose_plain)
    return fn(values, idx, bp, noise, d=d, scale=scale, vs_min=vs_min)


def gather_superpose_partial(values, idx, bp, out, offset: int = 0, *,
                             d: int, scale=None):
    """The local half of the sharded compressed superposition into the
    flat f32 ``out``: the raw sum_k w_k scatter(v_k, idx_k) at ``offset``
    (d columns), the raw sum of bp into the last slot, no noise, no
    division (``gather_superpose.gather_superpose_partial_*``); returns
    ``out``."""
    fn = (_gs.gather_superpose_partial_cuda
          if _route(values.device, "gather_superpose_partial")
          else _gs.gather_superpose_partial_plain)
    return fn(values, idx, bp, out, offset, d=d, scale=scale)


def round_stats_compressed(values, idx, resid, resid_idx, g, scale=None):
    """Round stats over the compressed plane and its EF residuals,
    ``(dots, dn2, pn2, gn2)``. Plain torch on both devices, as the
    reference's is plain jnp on every backend (a gather-bound sweep with
    no stripe contraction): ``round_stats.compressed_round_stats``."""
    return _rs.compressed_round_stats(values, idx, resid, resid_idx, g,
                                      scale=scale)


def ssd_intra_chunk_grouped(cum, b, c, xdt):
    """The Mamba2 SSD intra-chunk part in ``ssd_chunked``'s layouts: cum
    (Bz, NC, Q, H) f32, B and C (Bz, NC, Q, G, N) (strided views are taken
    as they are), xdt (Bz, NC, Q, H, P). Returns ``(y (Bz, NC, Q, H, P),
    state (Bz, NC, H, P, N) f32, chunk_decay (Bz, NC, H) f32)``. On the
    card, where autograd tracks an input, the kernel runs under
    ``ssd_intra_chunk_grouped_train`` (the forward kernel, then the
    backward kernel); on the CPU the twin runs under torch's autograd."""
    if _route(cum.device, "ssd_intra_chunk_grouped"):
        fn = (_ssd.ssd_intra_chunk_grouped_train
              if _swa.tracks_grad(cum, b, c, xdt)
              else _ssd.ssd_intra_chunk_grouped_cuda)
    else:
        fn = _ssd.ssd_intra_chunk_grouped_plain
    return fn(cum, b, c, xdt)


def ssd_intra_chunk(cum, b, c, xdt):
    """The reference-shaped SSD intra-chunk part over G = batch * chunks *
    heads cells: ``(y (G, Q, P), state (G, N, P) f32, chunk_decay (G,)
    f32)``; the same kernels as ``ssd_intra_chunk_grouped`` with H = G =
    1, routed the same way."""
    if _route(cum.device, "ssd_intra_chunk"):
        fn = (_ssd.ssd_intra_chunk_train if _swa.tracks_grad(cum, b, c, xdt)
              else _ssd.ssd_intra_chunk_cuda)
    else:
        fn = _ssd.ssd_intra_chunk_plain
    return fn(cum, b, c, xdt)


def swa_layout(q, k, v):
    """(B, T, H, D) q and (B, S, Hkv, D) k, v as the attention kernel takes
    them: each kv head repeated over its H / Hkv query heads (GQA), then
    (B H, T, D) / (B H, S, D) contiguous copies."""
    h = q.shape[2]
    if k.shape[2] != h:
        k = torch.repeat_interleave(k, h // k.shape[2], dim=2)
        v = torch.repeat_interleave(v, h // v.shape[2], dim=2)
    return [x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])
            .contiguous() for x in (q, k, v)]


def swa_attention(q, k, v, *, window=None, causal: bool = True):
    """Sliding-window attention in the (B, T, H, D) / (B, S, Hkv, D)
    layout: GQA repeats each kv head over its H / Hkv query heads, as the
    reference's ``repro.kernels.ops.swa_attention`` does; (B, T, H, D)
    out. On the card, where autograd tracks q, k or v, the kernel runs
    under ``swa_attention_train`` (forward with the log-sum-exp, backward
    kernel); the repeat and the layout copies stay outside it, so autograd
    sums dK and dV over each kv head's query heads. On the CPU the twin
    runs under torch's own autograd."""
    b, t, h, d = q.shape
    if _route(q.device, "swa_attention"):
        fn = (_swa.swa_attention_train if _swa.tracks_grad(q, k, v)
              else _swa.swa_attention_cuda)
    else:
        fn = _swa.swa_attention_plain
    out = fn(*swa_layout(q, k, v), window=window, causal=causal)
    return out.reshape(b, h, t, d).transpose(1, 2)
