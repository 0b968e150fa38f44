"""Mamba2 (SSD, state-space duality) blocks [arXiv:2405.21060], torch form.

Port of ``repro.models.ssm``: the chunked SSD forward for prefill
(quadratic inside a chunk, a state recurrence across chunks) and the O(1)
recurrent step for decode. The intra-chunk part always goes through
``kernels.ops.ssd_intra_chunk_grouped``, which dispatches by device: the CUDA
kernel for a tensor on the card, the plain twin on the CPU. The reference
reaches its Pallas kernel only with ``use_kernel=True``; both of its
branches compute the same function. The cross-chunk recurrence is a Python
loop over chunks in place of ``lax.scan``.

Params are a mapping of tensors under the reference's names (``in_proj``
(d_model, d_proj), ``conv_w`` (K, C), ``a_log``, ``dt_bias``, ``skip_d``,
``norm_scale``, ``out_proj`` (d_inner, d_model)), in the reference's
layouts, so ``x @ w`` reads as it does there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    h = cfg.ssm_nheads
    p = cfg.ssm_head_dim
    g = cfg.ssm_ngroups
    n = cfg.ssm_state
    d_xbc = d_in + 2 * g * n
    return d_in, h, p, g, n, d_xbc


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype):
    """One block's params at the reference's init scales, drawn from
    ``gen`` on its device."""
    d_in, h, p, g, n, d_xbc = _dims(cfg)
    dev = gen.device
    d_proj = 2 * d_in + 2 * g * n + h  # z, x, B, C, dt
    return {
        "in_proj": _normal(gen, (cfg.d_model, d_proj), dtype),
        "conv_w": _normal(gen, (cfg.conv_kernel, d_xbc), dtype, scale=0.2),
        "a_log": torch.zeros((h,), device=dev),          # A = -exp(a_log)
        "dt_bias": torch.full((h,), -2.0, device=dev),   # softplus(-2) ~ 0.13
        "skip_d": torch.ones((h,), device=dev),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": _normal(gen, (d_in, cfg.d_model), dtype,
                            scale=0.02 / math.sqrt(2.0 * cfg.num_layers)),
    }


def _split_proj(params, u, cfg: ModelConfig):
    d_in, h, p, g, n, d_xbc = _dims(cfg)
    zxbcdt = u @ params["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_xbc]
    dt = zxbcdt[..., d_in + d_xbc:]
    return z, xbc, dt


def _causal_conv(params, xbc, conv_state=None):
    """Depthwise causal conv of width K via shifted adds. xbc: (B, T, C);
    conv_state: (B, K-1, C), the tail of the previous tokens. Returns
    (silu(out), new (B, K-1, C) tail). The tail is a copy: a view would
    keep the whole (B, T+K-1, C) input alive in the caller's cache."""
    w = params["conv_w"]                      # (K, C)
    k = w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros(xbc.shape[:1] + (k - 1,) + xbc.shape[2:])
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                 # (B, T+K-1, C)
    t = xbc.shape[1]
    out = sum(full[:, i:i + t, :] * w[i][None, None, :] for i in range(k))
    new_state = full[:, full.shape[1] - (k - 1):, :].clone()
    return F.silu(out), new_state


def _gated_norm(params, y, z, cfg: ModelConfig):
    dt = y.dtype
    y32 = (y * F.silu(z)).float()
    ms = torch.square(y32).mean(-1, keepdim=True)
    return (y32 * torch.rsqrt(ms + cfg.norm_eps)
            * params["norm_scale"].float()).to(dt)


def ssd_chunked(x, dt, a, B, C, cfg: ModelConfig, init_state=None):
    """Chunked SSD forward.

    x: (Bz, T, H, P)  dt: (Bz, T, H)  a: (H,) negative
    B, C: (Bz, T, G, N). Returns (y (Bz, T, H, P), final_state
    (Bz, H, P, N) f32). T is padded up to a multiple of the chunk
    Q = min(cfg.ssm_chunk, T). The intra-chunk part takes B and C per
    group as the views they come in (no repeat over the heads, no
    permute): ``ops.ssd_intra_chunk_grouped`` shares each group's C B^T
    among its H / G heads.
    """
    bz, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(cfg.ssm_chunk, t)
    pad = (-t) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    tt = t + pad
    nc = tt // q
    rep = h // g  # heads per B/C group

    xc = x.reshape(bz, nc, q, h, p)
    dtc = dt.reshape(bz, nc, q, h)                        # (Bz,NC,Q,H)
    Bc = B.reshape(bz, nc, q, g, n)                       # views, per group
    Cc = C.reshape(bz, nc, q, g, n)

    da = dtc * a[None, None, None, :]                     # log-decay per step
    cum = torch.cumsum(da, dim=2)                         # (Bz,NC,Q,H)
    xdt = xc * dtc[..., None]

    # B and C meet the kernel in xdt's dtype (a no-op in f32; exact for
    # bf16, which widens to f32)
    y_intra, chunk_state, chunk_decay = ops.ssd_intra_chunk_grouped(
        cum, Bc.to(xdt.dtype), Cc.to(xdt.dtype), xdt)

    # cross-chunk recurrence: the state before each chunk
    s = (torch.zeros((bz, h, p, n), device=x.device) if init_state is None
         else init_state)
    prev = []
    for i in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, i, :, None, None] + chunk_state[:, i].float()
    prev_states = torch.stack(prev, dim=1)                # (Bz,NC,H,P,N)

    # inter-chunk output: C_i . (decay_to_i * S_prev), contracted per group
    # and scaled by the decay after (the reference scales C first: a
    # rounding-order change only)
    into = torch.exp(torch.clamp(cum, -60.0, 0.0))        # from chunk start
    s_grp = prev_states.to(Cc.dtype).float().view(bz, nc, g, rep, p, n)
    y_inter = torch.einsum("bcign,bcgrpn->bcigrp", Cc.float(), s_grp)
    y_inter = y_inter.reshape(bz, nc, q, h, p) * into[..., None]

    y = (y_intra + y_inter).reshape(bz, tt, h, p)[:, :t]
    return y.to(x.dtype), s


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device):
    d_in, h, p, g, n, d_xbc = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, p, n), device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_xbc), dtype=dtype,
                            device=device),
    }


def apply_mamba2(params, u, cfg: ModelConfig, state=None):
    """Full-sequence forward (prefill). u: (B, T, d_model).
    Returns (out (B, T, d_model), new state {"ssm", "conv"})."""
    d_in, h, p, g, n, d_xbc = _dims(cfg)
    bz, t, _ = u.shape
    z, xbc, dt = _split_proj(params, u, cfg)
    conv_in = None if state is None else state["conv"]
    xbc, conv_state = _causal_conv(params, xbc, conv_in)
    x = xbc[..., :d_in].reshape(bz, t, h, p)
    B = xbc[..., d_in:d_in + g * n].reshape(bz, t, g, n)
    C = xbc[..., d_in + g * n:].reshape(bz, t, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    init_s = None if state is None else state["ssm"]
    y, final_state = ssd_chunked(x, dt, a, B, C, cfg, init_s)
    y = y + x * params["skip_d"][None, None, :, None].to(y.dtype)
    y = _gated_norm(params, y.reshape(bz, t, d_in), z, cfg)
    out = y @ params["out_proj"]
    return out, {"ssm": final_state, "conv": conv_state}


def apply_mamba2_decode(params, u, state, cfg: ModelConfig):
    """Single-token recurrent step. u: (B, 1, d_model); O(1) in the
    context length."""
    d_in, h, p, g, n, d_xbc = _dims(cfg)
    bz = u.shape[0]
    z, xbc, dt = _split_proj(params, u, cfg)
    xbc, conv_state = _causal_conv(params, xbc, state["conv"])
    x = xbc[:, 0, :d_in].reshape(bz, h, p)
    B = xbc[:, 0, d_in:d_in + g * n].reshape(bz, g, n)
    C = xbc[:, 0, d_in + g * n:].reshape(bz, g, n)
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])    # (B, H)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt1 * a[None, :])                        # (B, H)
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=1)                # (B, H, N)
    Ch = torch.repeat_interleave(C, rep, dim=1)
    xdt = (x * dt1[..., None]).float()
    s_new = (state["ssm"] * decay[:, :, None, None]
             + torch.einsum("bhn,bhp->bhpn", Bh.float(), xdt))
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), s_new)
    y = y.to(u.dtype) + x * params["skip_d"][None, :, None].to(u.dtype)
    y = _gated_norm(params, y.reshape(bz, 1, d_in), z, cfg)
    out = y @ params["out_proj"]
    return out, {"ssm": s_new, "conv": conv_state}
