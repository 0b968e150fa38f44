"""Mixture-of-Experts layer, torch form: a top-k router with GShard-style
grouped capacity dispatch (llama4-maverick, 128 experts top-1;
mixtral-8x22b, 8 experts top-2).

Port of ``repro.models.moe``'s single-device branch. Tokens are cut into
groups of g = min(``moe_group_size``, tokens), zero rows padding the last
group; the pad rows go through the router and count in the aux loss, and
sit after the real tokens, so they never take a real token's place. In a
group, a token's place in an expert's queue follows token order (not
whether the expert was its first or second choice), and a token past the
expert's capacity C = max(int(capacity_factor k g / E), 1) is dropped
from that expert: its share of the output is lost, as in the reference.

The reference dispatches with one-hot einsums into (G, E, C, d) slots and
combines with another. The port copies each kept (token, expert) pair
into the same slot by index and gathers it back, so the routing (the
chosen experts, the keep mask, each token's slot) is the reference's bit
for bit and the values agree up to f32 summation order. The expert
products are plain batched matmuls over every expert's slots, as the
reference's einsums are plain (no Pallas kernel). The router's softmax is
f32; dispatch and combine run in x's dtype.

The multi-device dispatch (``act_ep`` set with ``act_ep_size > 1``: the
reference's shard_map all-to-all) belongs to the multi-GPU slice and
raises ``NotImplementedError``; with ``act_ep`` None and ``act_dp`` empty
the reference's sharding constraints are no-ops, and the port has none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype):
    """The router (d, E) and the stacked experts' SwiGLU weights: gate and
    up (E, d, ff), down (E, ff, d) at the depth scale."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    depth_scale = 0.02 / math.sqrt(2.0 * cfg.num_layers)
    down = L._normal(gen, (e, ff, d), dtype)
    return {"router": {"w": L._normal(gen, (d, e), dtype)},
            "gate": L._normal(gen, (e, d, ff), dtype),
            "up": L._normal(gen, (e, d, ff), dtype),
            "down": down.mul_(float(depth_scale) / 0.02)}


def _group_capacity(g: int, cfg: ModelConfig) -> int:
    cap = int(cfg.capacity_factor * cfg.experts_per_token * g
              / max(cfg.num_experts, 1))
    return max(cap, 1)


def _top_k(probs, k: int):
    """``lax.top_k``'s order: descending, ties to the lower index (a
    stable sort; ``torch.topk`` promises no order for ties)."""
    val, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _route(probs, cfg: ModelConfig):
    """(weights (..., E): the normalized top-k probs at the chosen experts,
    zero elsewhere; the chosen experts (..., k); the load-balance loss)."""
    topv, topi = _top_k(probs, cfg.experts_per_token)
    weights = torch.zeros_like(probs).scatter_(
        -1, topi, topv / topv.sum(-1, keepdim=True))
    # load-balance loss: E * sum_e f_e * p_e (Switch Transformer eq. 4)
    e = cfg.num_experts
    counts = torch.zeros_like(probs).scatter_(-1, topi, 1.0)
    f = counts.reshape(-1, e).mean(0)
    p = probs.reshape(-1, e).mean(0)
    return weights, topi, e * (f * p).sum()


def router_topk(logits, cfg: ModelConfig):
    """Top-k routing with the load-balance aux loss (Switch / GShard).
    logits: (..., E). Returns (weights (..., E) f32, nonzero only at the
    chosen experts, rows summing to 1; aux f32 scalar)."""
    weights, _, aux = _route(torch.softmax(logits.float(), dim=-1), cfg)
    return weights, aux


def route(params, xg, cfg: ModelConfig, cap: int):
    """The routing of token groups xg (G, g, d) at capacity ``cap``:
    (weights (G, g, E) f32, zero where not kept; keep (G, g, E) int32;
    pos (G, g, E): each token's place in each expert's queue, -1 where the
    expert is not chosen; the chosen experts (G, g, k); aux)."""
    logits = L.apply_dense(params["router"], xg)
    weights, topi, aux = _route(torch.softmax(logits.float(), dim=-1), cfg)
    chosen = (weights > 0).to(torch.int32)
    pos = torch.cumsum(chosen, dim=1) * chosen - 1
    keep = chosen * (pos < cap)
    return weights * keep, keep, pos, topi, aux


def _check_single_device(cfg: ModelConfig) -> None:
    if cfg.act_ep is not None and cfg.act_ep_size > 1:
        raise NotImplementedError(
            f"apply_moe with act_ep={cfg.act_ep!r} over {cfg.act_ep_size} "
            f"devices ({cfg.name}): the expert-parallel all-to-all dispatch "
            f"belongs to the multi-GPU slice, which is not ported yet")


def dispatch(params, x, cfg: ModelConfig):
    """Route x (B, T, d) and copy each kept (token, expert) pair into its
    slot. Returns (exp_in (E, G C, d): the slots, zero where empty; rows
    (N, k): each choice's slot row, 0 where dropped; w (N, k, 1) in x's
    dtype: each choice's weight, 0 where dropped; aux), N counting the pad
    rows."""
    _check_single_device(cfg)
    b, t, d = x.shape
    n_tok = b * t
    g = min(cfg.moe_group_size, n_tok)
    pad = (-n_tok) % g
    xt = x.reshape(n_tok, d)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    ng = (n_tok + pad) // g
    xg = xt.reshape(ng, g, d)
    cap = _group_capacity(g, cfg)
    weights, keep, pos, topi, aux = route(params, xg, cfg, cap)

    # each choice's slot row in the (E, G, C) table; dropped copies go to
    # one spare row past the table, which nothing reads
    e, k = cfg.num_experts, cfg.experts_per_token
    kept = torch.gather(keep, -1, topi).bool().reshape(-1, k)
    group = torch.arange(ng, device=x.device).view(ng, 1, 1)
    slot = ((topi * ng + group) * cap
            + torch.gather(pos, -1, topi)).reshape(-1, k)
    w = torch.gather(weights, -1, topi).reshape(-1, k, 1).to(x.dtype)
    n_slots = e * ng * cap
    buf = x.new_zeros((n_slots + 1, d))
    src = xg.reshape(-1, d)
    for j in range(k):
        buf.index_copy_(0, torch.where(kept[:, j], slot[:, j], n_slots), src)
    return (buf[:n_slots].view(e, ng * cap, d), torch.where(kept, slot, 0),
            w, aux)


def expert_ffn(params, exp_in):
    """Every expert's SwiGLU over its slots: (E, G C, d) -> (E, G C, d).
    Serving runs the activation in place; under autograd (whose silu and
    mul keep their inputs) out of place, with the same values."""
    h = torch.bmm(exp_in, params["gate"])               # (E, G C, ff)
    u = torch.bmm(exp_in, params["up"])
    if torch.is_grad_enabled() and (h.requires_grad or u.requires_grad):
        act = F.silu(h) * u
    else:
        act = F.silu(h, inplace=True).mul_(u)
    del u
    return torch.bmm(act, params["down"])


def combine(exp_out, rows, w):
    """Each token's kept slots, weighted (a dropped choice reads row 0 at
    weight 0): (N, d)."""
    flat = exp_out.view(-1, exp_out.shape[-1])
    out = flat[rows[:, 0]] * w[:, 0]
    for j in range(1, rows.shape[1]):
        out += flat[rows[:, j]] * w[:, j]
    return out


def apply_moe(params, x, cfg: ModelConfig):
    """x: (B, T, d). Returns (out (B, T, d), aux f32 scalar)."""
    b, t, d = x.shape
    exp_in, rows, w, aux = dispatch(params, x, cfg)
    exp_out = expert_ffn(params, exp_in)
    del exp_in
    return combine(exp_out, rows, w)[:b * t].reshape(b, t, d), aux
