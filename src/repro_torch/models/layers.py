"""The layers of the dense, SSM and hybrid language models, torch form:
initializers, dense layers, RMSNorm (and OLMo's non-parametric LayerNorm),
RoPE, attention for prefill and for decode over a KV ring (f32 or int8
with per-(token, head) scales), the SwiGLU MLP, the token embedding and
the unembedding.

Port of ``repro.models.layers``. Params are plain mappings of tensors (a
dict, or an ``nn.ParameterDict`` / ``nn.ModuleDict`` inside a module)
under the reference's names. Initializers draw from an explicit
``torch.Generator`` at the reference's scales; the stream differs from
``jax.random``'s, so parity tests carry the reference's params across.

Prefill and training attention go through ``kernels.ops.swa_attention``
(the CUDA kernel on the card, with its backward kernel under autograd; its
plain twin on the CPU) in place of both of the reference's routes (the
masked einsum up to ``ATTN_CHUNK_THRESHOLD`` keys and the ``_flash`` scan
with its custom VJP beyond): one function, the same mask. It takes
positions ``arange(T)`` only. Decode attention and the int8 KV
helpers are plain torch, as the reference's are plain jnp.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import f32
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, dtype, scale=0.02):
    """``scale * N(0, 1)`` drawn in f32 on the generator's device, then cast
    (the reference's ``_normal``)."""
    return (scale * torch.randn(shape, generator=gen,
                                device=gen.device)).to(dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 0.02):
    return {"w": _normal(gen, (d_in, d_out), dtype, scale)}


def apply_dense(params, x):
    return x @ params["w"]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(params, x, cfg: ModelConfig):
    """RMSNorm (llama family) or non-parametric LayerNorm (OLMo), in f32,
    cast back to x's dtype."""
    dt = x.dtype
    x32 = x.float()
    if cfg.norm == "nonparam_ln":
        mu = x32.mean(-1, keepdim=True)
        var = torch.square(x32 - mu).mean(-1, keepdim=True)
        return ((x32 - mu) * torch.rsqrt(var + cfg.norm_eps)).to(dt)
    ms = torch.square(x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + cfg.norm_eps)
    if params is not None:
        y = y * params["scale"].float()
    return y.to(dt)


def maybe_init_norm(d: int, cfg: ModelConfig, dtype, device):
    return None if cfg.norm == "nonparam_ln" else init_rmsnorm(d, dtype,
                                                               device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device):
    """The f32 frequencies ``exp(-log(theta) i / half)``, i < half, as the
    reference writes them, computed once on the CPU and kept on
    ``device``: the card's ``expf`` rounds some of them a last bit apart
    from the CPU's (at half = 40, hubert-xlarge's D = 80), and at position
    p that bit turns the angle by p times its size. So every device
    rotates by the same angles."""
    with torch.inference_mode(False):
        log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
        freq = torch.exp(-log_theta * (torch.arange(
            half, dtype=torch.float32) / half))
        return freq.to(device)


def rope_rotate(x, positions, theta: float):
    """Rotary embedding. x: (..., T, H, D); positions: (..., T) integers.
    The frequencies (``_rope_freq``) and angles are f32, as the
    reference's; an odd head dim's last channel passes through."""
    d = x.shape[-1]
    half = d // 2
    freq = _rope_freq(half, float(theta), x.device)
    ang = positions[..., :, None].float() * freq          # (..., T, half)
    cos = torch.cos(ang)[..., :, None, :]                 # (..., T, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    parts = [x1 * cos - x2 * sin, x1 * sin + x2 * cos]
    if d > 2 * half:
        parts.append(x[..., 2 * half:])
    return torch.cat(parts, dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window): prefill and decode
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    depth_scale = 0.02 / math.sqrt(2.0 * cfg.num_layers)
    return {"wq": init_dense(gen, d, h * hd, dtype),
            "wk": init_dense(gen, d, hkv * hd, dtype),
            "wv": init_dense(gen, d, hkv * hd, dtype),
            "wo": {"w": _normal(gen, (h * hd, d), dtype, depth_scale)}}


def _gqa_scores(q, k, cfg: ModelConfig):
    """q: (B, T, Hq, D), k: (B, S, Hkv, D) -> f32 logits (B, Hkv, G, T, S)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    return logits / f32(math.sqrt(d))


def _attend(q, k, v, mask, cfg: ModelConfig):
    """mask: bool broadcastable to (B, 1, 1, T, S), True = attend."""
    logits = torch.where(mask, _gqa_scores(q, k, cfg), -1e30)
    probs = torch.softmax(logits, dim=-1)
    b, t, hq = q.shape[:3]
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(b, t, hq, v.shape[3]).to(q.dtype)


def causal_window_mask(t_positions, s_positions, window: Optional[int]):
    """True where the query at t may attend to the key at s (causal,
    optional window)."""
    tq = t_positions[..., :, None]
    sk = s_positions[..., None, :]
    m = sk <= tq
    if window is not None:
        m = m & (sk > tq - window)
    return m


def _check_prefill_positions(pos, t: int, what: str) -> None:
    """Raise unless ``pos`` (B, T) or (T,) is ``arange(T)`` in every row
    (a host read: only a caller that passes positions pays it)."""
    want = torch.arange(t, device=pos.device)
    if pos.shape[-1] != t or not bool((pos == want).all()):
        raise NotImplementedError(
            f"attend_positions: {what} positions other than arange(T) "
            f"(the prefill layout) are not ported; the port's prefill "
            f"attention is the swa_attention kernel's band")


def attend_positions(q, k, v, cfg: ModelConfig, q_pos, k_pos,
                     window: Optional[int], causal: bool):
    """Prefill attention over (B, T, H, D) q and (B, S, Hkv, D) k, v through
    ``ops.swa_attention``: query t attends to key s where s <= t (causal)
    and s > t - window, as the reference's mask. ``q_pos`` / ``k_pos`` are
    None (meaning ``arange(T)``, no check) or that layout; any other raises
    ``NotImplementedError``."""
    t, s = q.shape[1], k.shape[1]
    if (q_pos is not None or k_pos is not None) and s != t:
        raise NotImplementedError(
            f"attend_positions: S={s} keys for T={t} queries is not the "
            f"prefill layout and is not ported")
    for pos, what in ((q_pos, "query"), (k_pos, "key")):
        if pos is not None:
            _check_prefill_positions(pos, t, what)
    return ops.swa_attention(q, k, v, window=window, causal=causal)


def apply_attention(params, x, cfg: ModelConfig, positions=None):
    """Full-sequence attention (prefill). x: (B, T, d_model); positions:
    (B, T), or None for ``arange(T)`` (built on the device, never read
    back). Returns (out (B, T, d_model), (k, v) (B, T, Hkv, D) after RoPE,
    the prefill caches)."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = apply_dense(params["wq"], x).reshape(b, t, h, hd)
    k = apply_dense(params["wk"], x).reshape(b, t, hkv, hd)
    v = apply_dense(params["wv"], x).reshape(b, t, hkv, hd)
    pos = (torch.arange(t, device=x.device) if positions is None
           else positions)
    q = rope_rotate(q, pos, cfg.rope_theta)
    k = rope_rotate(k, pos, cfg.rope_theta)
    out = attend_positions(q, k, v, cfg, positions, positions,
                           cfg.sliding_window, cfg.causal)
    return apply_dense(params["wo"], out.reshape(b, t, h * hd)), (k, v)


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                  device):
    """One layer's KV cache: a ring of ``min(seq_len, window)`` slots for a
    sliding-window arch, else ``seq_len``. With ``kv_quant`` an int8
    payload and per-(token, head) f16 scales."""
    size = (seq_len if cfg.sliding_window is None
            else min(seq_len, cfg.sliding_window))
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x):
    """x: (..., Hkv, D) -> (int8 payload, f16 per-(token, head) scale
    (..., Hkv)): the payload is rounded with the f32 scale, which is then
    stored in f16, as in the reference (decode and the prefill hand-off)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()[..., None]).to(dtype)


def _attend_quant(q, kq, ks, vq, vs, mask, cfg: ModelConfig):
    """Decode attention on the int8 cache: the per-(token, head) scales
    fold into the logits and the probs (no dequantized copy)."""
    b, t, hq, d = q.shape
    hkv = kq.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, d).float() * f32(1.0 / math.sqrt(d))
    logits = torch.einsum("btkgd,bskd->bkgts", qg, kq.float())
    logits = logits * ks.float().transpose(1, 2)[:, :, None, None, :]
    probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    probs = probs * vs.float().transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bkgts,bskd->btkgd", probs, vq.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def apply_attention_decode(params, x, cache, index: int, cfg: ModelConfig):
    """Single-token decode step. x: (B, 1, d_model); cache: the ring
    ``{"k", "v"}`` (B, S_c, Hkv, D) (int8 with ``"k_scale"``,
    ``"v_scale"`` (B, S_c, Hkv) f16 under ``kv_quant``); index: a host int,
    the tokens already in the cache. The new token's K/V are written into
    slot ``index % S_c`` of the cache in place (the reference returns an
    updated copy). Returns (out (B, 1, d_model), the cache)."""
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s_c = cache["k"].shape[1]
    index = int(index)
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q = apply_dense(params["wq"], x).reshape(b, 1, h, hd)
    k = apply_dense(params["wk"], x).reshape(b, 1, hkv, hd)
    v = apply_dense(params["wv"], x).reshape(b, 1, hkv, hd)
    q = rope_rotate(q, pos, cfg.rope_theta)
    k = rope_rotate(k, pos, cfg.rope_theta)

    slot = index % s_c                      # ring-buffer write position
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            cache[name][:, slot] = val[:, 0]
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]

    # slot j holds absolute position abs_pos[j] after the write; attend
    # iff 0 <= abs_pos <= index (and abs_pos > index - window)
    j = torch.arange(s_c, device=x.device)
    abs_pos = torch.where(j <= slot, index - slot + j,
                          index - slot + j - s_c)
    valid = (abs_pos >= 0) & (abs_pos <= index)
    if cfg.sliding_window is not None:
        valid = valid & (abs_pos > index - cfg.sliding_window)
    mask = valid[None, None, None, None, :]          # (1, 1, 1, 1, S_c)
    if cfg.kv_quant:
        out = _attend_quant(q, cache["k"], cache["k_scale"], cache["v"],
                            cache["v_scale"], mask, cfg)
    else:
        out = _attend(q, cache["k"], cache["v"], mask, cfg)
    return apply_dense(params["wo"], out.reshape(b, 1, h * hd)), cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype,
             d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    depth_scale = 0.02 / math.sqrt(2.0 * cfg.num_layers)
    return {"gate": init_dense(gen, d, ff, dtype),
            "up": init_dense(gen, d, ff, dtype),
            "down": {"w": _normal(gen, (ff, d), dtype, depth_scale)}}


def apply_mlp(params, x, cfg: Optional[ModelConfig] = None):
    """``down(silu(gate x) * up x)``; ``cfg`` carries only the reference's
    sharding hint, which the single-device port does not read."""
    h = F.silu(apply_dense(params["gate"], x))
    h = h * apply_dense(params["up"], x)
    return apply_dense(params["down"], h)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig, dtype):
    p = {"embed": _normal(gen, (cfg.vocab_size, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return p


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens]


def unembed(params, x, cfg: ModelConfig):
    """f32 logits (..., V): ``x @ embed^T`` when tied."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = x @ params["unembed"]
    return (logits * cfg.logit_scale).float()
