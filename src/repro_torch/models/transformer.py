"""Model assembly, torch form: the ``dense`` family (smollm-135m, olmo-1b,
minicpm-2b, granite-3-8b: L attention + SwiGLU blocks), the ``moe`` family
(mixtral-8x22b, llama4-maverick-400b-a17b: L attention + MoE blocks), the
``ssm`` family (mamba2-370m), the ``hybrid`` family (zamba2-7b: the
Mamba2 trunk plus one shared attention + SwiGLU block applied before every
``shared_attn_period``-th layer), the ``vlm`` family (internvl2-1b: a
dense decoder over [projected patch embeddings; text tokens]) and the
``audio`` family (hubert-xlarge: a bidirectional encoder over projected
frame features, ``mask_emb`` in place of the masked frames).

Port of ``repro.models.transformer``. The reference stacks its layers
along a leading L axis and scans them; the port keeps one ``nn.Module`` per
block in a ``ModuleList`` and loops, and holds the shared block once (an
``AttentionBlock``, the dense family's block with one set of weights).
Caches and decode states keep the reference's stacked layout and names:
for the dense and moe families ``{"k", "v"}``, each layer's post-RoPE K/V
of shape (L, B, T, Hkv, D) after a prefill, and rings (L, B, S_c, Hkv, D)
in a decode state (int8 with ``k_scale`` / ``v_scale`` (L, B, S_c, Hkv)
f16 under ``kv_quant``); for the recurrent families ``{"ssm": (L, B, H, P,
N) f32, "conv": (L, B, K-1, C)}`` and, for the hybrid family, ``shared_kv``,
the shared block's K/V of shape (n_slots, B, T, Hkv, D) after a prefill
and its rings (n_slots, B, S_c, Hkv, D) in a decode state. Where the
reference makes a dummy K/V for every layer without the shared block and
selects the slots afterwards, the port writes only the slots.

As in the reference, every layer of a config with ``num_experts > 0`` is
an MoE layer: ``init_block`` reads neither ``moe_layer_period`` nor
``is_moe_layer`` (both zoo configs have period 1). The forward returns
the layers' mean load-balance loss (``aux / num_layers``); decode drops
it. The forward takes the reference's batch dict (``embed_inputs``):
``tokens``, and for the vlm family ``patch_embeds`` (B, P, F), for the
audio family ``frame_feats`` (B, T, F) and an optional
``mask_indicator`` (B, T). vlm decode is the dense family's: the rings
hold the P + T prefill positions and decode takes tokens only. The
encoder-only audio family has no decode state and no decode step; asking
for one, and the hybrid + ``kv_quant`` prefill hand-off, raise
``NotImplementedError`` naming themselves. Decode writes the new K/V into
the rings in place, under ``torch.inference_mode()``.

Training: params are built without gradients (serving); ``trainable()``
turns them on, and ``launch.steps.make_paota_train_step`` drives client
views of a stacked store through ``torch.func.functional_call`` instead.
``loss_fn`` is the reference's for every family: the causal-LM loss, the
vlm text loss, the audio masked-prediction loss, the moe family's
``router_aux_weight * aux``, and the cross-entropy streamed in chunks of
512 tokens (each chunk recomputed in the backward) above
``XENT_CHUNK_THRESHOLD``. ``cfg.remat == "block"`` checkpoints each
block under autograd (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` per layer). On the card the attention families train
through the attention kernel and its backward, the ssm and hybrid
families through the SSD intra-chunk kernel and its backward (the
hybrid's shared block through the attention pair too); on the CPU every
family trains through the twins under torch's autograd.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import f32, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig


def _pdict(params: Optional[dict]) -> Optional[nn.ParameterDict]:
    if params is None:
        return None
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


class _Params(nn.Module):
    """A params dict of tensors and sub-dicts side by side (the MoE
    layer's router beside its stacked experts): ``m["gate"]`` reads a
    tensor and ``m["router"]["w"]`` a sub-dict's, as the reference's
    ``params[...]``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, _pnest(v))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _pnest(tree: Optional[dict]):
    """A nested params dict as modules: a dict of tensors becomes an
    ``nn.ParameterDict``, a dict of dicts an ``nn.ModuleDict`` of them and
    a mixed dict a ``_Params``, so ``m["wq"]["w"]`` reads as the
    reference's ``params["wq"]["w"]``."""
    if tree is None or all(isinstance(v, torch.Tensor)
                           for v in tree.values()):
        return _pdict(tree)
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        return _Params(tree)
    return nn.ModuleDict({k: _pnest(v) for k, v in tree.items()})


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the families whose trunk is L attention blocks
ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"port runs the families {PORTED_FAMILIES}")


def _check_decode(cfg: ModelConfig) -> None:
    """The reference has no decode path for an encoder-only config (its
    shapes skip the decode cells; its serve example exits)."""
    if cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name} is encoder_only: it has no decode state or decode "
            f"step")


def n_shared_slots(cfg: ModelConfig) -> int:
    if cfg.shared_attn_period <= 0:
        return 0
    return -(-cfg.num_layers // cfg.shared_attn_period)


class MambaBlock(nn.Module):
    """RMSNorm, Mamba2 mixer, residual (``apply_mamba_block_full`` /
    ``_decode`` of the reference)."""

    def __init__(self, mamba: dict, norm: Optional[dict]):
        super().__init__()
        self.mamba = _pdict(mamba)
        self.norm = _pdict(norm)

    def forward(self, x, cfg: ModelConfig, state=None):
        h = L.apply_norm(self.norm, x, cfg)
        out, new_state = SSM.apply_mamba2(self.mamba, h, cfg, state)
        return x + cfg.residual_scale * out, new_state

    def decode(self, x, state, cfg: ModelConfig):
        h = L.apply_norm(self.norm, x, cfg)
        out, new_state = SSM.apply_mamba2_decode(self.mamba, h, state, cfg)
        return x + cfg.residual_scale * out, new_state


class AttentionBlock(nn.Module):
    """Norm, attention, residual, norm, FFN, residual, each residual scaled
    by ``residual_scale`` (``apply_block_full`` / ``_decode`` of the
    reference). The FFN is the SwiGLU MLP (``mlp``: a dense layer, and
    zamba2's one shared block, reused at every slot) or the MoE layer
    (``moe``: an moe-family layer). OLMo's norms have no params (``ln1`` /
    ``ln2`` None)."""

    def __init__(self, params: dict):
        super().__init__()
        self.attn = _pnest(params["attn"])
        self.mlp = _pnest(params.get("mlp"))
        self.moe = _pnest(params.get("moe"))
        self.ln1 = _pdict(params["ln1"])
        self.ln2 = _pdict(params["ln2"])

    def _ffn(self, h, cfg: ModelConfig):
        """(h + scale * FFN(norm(h)), the MoE aux loss or None)."""
        z = L.apply_norm(self.ln2, h, cfg)
        if self.moe is None:
            return h + cfg.residual_scale * L.apply_mlp(self.mlp, z), None
        out, aux = MOE.apply_moe(self.moe, z, cfg)
        return h + cfg.residual_scale * out, aux

    def forward(self, x, cfg: ModelConfig):
        """Prefill over positions arange(T): (x, (k, v) (B, T, Hkv, D), the
        MoE aux loss or None)."""
        z = L.apply_norm(self.ln1, x, cfg)
        a_out, kv = L.apply_attention(self.attn, z, cfg)
        x, aux = self._ffn(x + cfg.residual_scale * a_out, cfg)
        return x, kv, aux

    def decode(self, x, cache, index: int, cfg: ModelConfig):
        """One token; writes its K/V into the ring ``cache``."""
        z = L.apply_norm(self.ln1, x, cfg)
        a_out, _ = L.apply_attention_decode(self.attn, z, cache, index, cfg)
        return self._ffn(x + cfg.residual_scale * a_out, cfg)[0]


class LanguageModel(nn.Module):
    """Input embedding, L blocks (dense, moe, vlm and audio:
    ``AttentionBlock``; ssm and hybrid: ``MambaBlock``, with the hybrid
    family's shared attention block before every ``shared_attn_period``-th
    one), final norm and the unembedding, built from params in the
    reference's structure: ``{"embedding": {...}, "layers": [block, ...],
    "shared_attn": {...} (hybrid), "final_norm": ..., "projector": {"w"}
    (vlm), "frontend_proj": {"w"}, "mask_emb" (audio)}``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embedding = _pdict(params["embedding"])
        if cfg.family in ATTENTION_FAMILIES:
            self.layers = nn.ModuleList(AttentionBlock(b)
                                        for b in params["layers"])
        else:
            self.layers = nn.ModuleList(MambaBlock(b["mamba"], b["norm"])
                                        for b in params["layers"])
        self.shared_attn = (AttentionBlock(params["shared_attn"])
                            if cfg.family == "hybrid" else None)
        self.final_norm = _pdict(params["final_norm"])
        self.projector = _pdict(params.get("projector"))
        self.frontend_proj = _pdict(params.get("frontend_proj"))
        self.mask_emb = (nn.Parameter(params["mask_emb"], requires_grad=False)
                         if "mask_emb" in params else None)

    def _shared_at(self, i: int) -> bool:
        return (self.shared_attn is not None
                and i % self.cfg.shared_attn_period == 0)

    @property
    def device(self) -> torch.device:
        return self.embedding["embed"].device

    def trainable(self) -> "LanguageModel":
        """Let every param take gradients: params are built without, for
        serving."""
        return self.requires_grad_(True)

    def _remat(self) -> bool:
        """Checkpoint each block: ``cfg.remat == "block"`` and autograd on
        (serving runs with it off and is unchanged)."""
        return self.cfg.remat == "block" and torch.is_grad_enabled()

    def embed_inputs(self, batch: dict):
        """The reference's ``embed_inputs``: (B, T, d) in the param dtype
        at positions arange(T). vlm: the projected ``patch_embeds`` (B, P,
        F) before the text tokens' embeddings (T = P + T_text); audio: the
        projected ``frame_feats`` (B, T, F), and where ``mask_indicator``
        is given, ``x * (1 - m) + mask_emb * m`` (the reference's formula,
        so the values are bit-equal); else the tokens' embeddings."""
        cfg = self.cfg
        dtype = L.torch_dtype(cfg.param_dtype)
        if cfg.modality == "vision_text":
            proj = L.apply_dense(self.projector,
                                 batch["patch_embeds"].to(dtype))
            tok = L.embed_tokens(self.embedding, batch["tokens"], cfg)
            return torch.cat([proj, tok], dim=1)
        if cfg.modality == "audio":
            x = L.apply_dense(self.frontend_proj,
                              batch["frame_feats"].to(dtype))
            if "mask_indicator" in batch:
                m = batch["mask_indicator"][..., None].to(dtype)
                x = x * (1 - m) + self.mask_emb[None, None, :] * m
            return x
        return L.embed_tokens(self.embedding, batch["tokens"], cfg)

    def forward(self, batch: dict, return_cache: bool = False,
                return_hidden: bool = False):
        """Full-sequence forward over the batch (``embed_inputs``) at
        positions arange(T). Returns (logits (B, T, V) f32 | hidden (B, T,
        d), aux, caches | None); aux is the layers' mean MoE load-balance
        loss, 0.0 outside the moe family. The caches are written layer by
        layer into preallocated stacks: for the attention families ``{"k",
        "v"}`` (L, B, T, Hkv, D) (vlm: T = P + T_text); for the recurrent
        families ``{"ssm_states": {"ssm", "conv"}}`` stacked over layers
        and, for the hybrid family, ``{"shared_kv": {"k", "v"}}`` (n_slots,
        B, T, Hkv, D)."""
        cfg = self.cfg
        x = self.embed_inputs(batch)
        aux = torch.zeros((), device=x.device)
        if cfg.family in ATTENTION_FAMILIES:
            x, caches, aux = self._forward_attention(x, aux, return_cache)
        else:
            x, caches = self._forward_recurrent(x, return_cache)
        x = L.apply_norm(self.final_norm, x, cfg)
        if return_hidden:
            return x, aux, caches
        return L.unembed(self.embedding, x, cfg), aux, caches

    def _kv_stack(self, x, n: int):
        b, t = x.shape[:2]
        shape = (n, b, t, self.cfg.num_kv_heads, self.cfg.head_dim)
        return {"k": x.new_empty(shape), "v": x.new_empty(shape)}

    def _forward_attention(self, x, aux, return_cache: bool):
        kv = self._kv_stack(x, len(self.layers)) if return_cache else None
        remat = self._remat()
        for i, block in enumerate(self.layers):
            if remat:
                x, (k, v), aux_l = checkpoint(block, x, self.cfg,
                                              use_reentrant=False)
            else:
                x, (k, v), aux_l = block(x, self.cfg)
            if kv is not None:
                kv["k"][i] = k
                kv["v"][i] = v
            del k, v
            if aux_l is not None:
                aux = aux + aux_l
        if self.cfg.family == "moe":
            aux = aux / self.cfg.num_layers
        return x, kv, aux

    def _forward_recurrent(self, x, return_cache: bool):
        cfg = self.cfg
        ssm, conv = [], []
        shared_kv = None
        if return_cache and self.shared_attn is not None:
            shared_kv = self._kv_stack(x, n_shared_slots(cfg))
        remat = self._remat() and not return_cache
        for i, block in enumerate(self.layers):
            if remat:
                x = checkpoint(self._recurrent_layer, x, i,
                               use_reentrant=False)
                continue
            if self._shared_at(i):
                x, (k, v), _ = self.shared_attn(x, cfg)
                if shared_kv is not None:
                    slot = i // cfg.shared_attn_period
                    shared_kv["k"][slot] = k
                    shared_kv["v"][slot] = v
                del k, v
            x, state = block(x, cfg)
            if return_cache:
                ssm.append(state["ssm"])
                conv.append(state["conv"])
        caches = None
        if return_cache:
            caches = {"ssm_states": {"ssm": torch.stack(ssm),
                                     "conv": torch.stack(conv)}}
            if shared_kv is not None:
                caches["shared_kv"] = shared_kv
        return x, caches

    def _recurrent_layer(self, x, i: int):
        """Layer i of the recurrent trunk without caches: the shared block
        where it sits, then the Mamba2 block (one remat unit, as the
        reference's scan body)."""
        if self._shared_at(i):
            x = self.shared_attn(x, self.cfg)[0]
        return self.layers[i](x, self.cfg)[0]

    def init_decode_state(self, batch: int, seq_len: int):
        return init_decode_state(self.cfg, batch, seq_len, self.device)

    def cache_from_prefill(self, caches, batch: int, seq_len: int,
                           prefill_len: int):
        return cache_from_prefill(caches, self.cfg, batch, seq_len,
                                  prefill_len)

    def decode_step(self, tokens, state, index: int):
        """One-token decode. tokens: (B, 1) int; index: a host int, the
        tokens so far (the rings' position; unused by the SSM family).
        Returns (logits (B, 1, V) f32, new state); the KV rings (the
        attention families', the hybrid family's ``shared_kv``) are the
        state's own, updated in place. vlm: tokens only, at index P +
        T_text and on (the reference's ``decode_step`` ignores
        ``patch_embeds``)."""
        cfg = self.cfg
        _check_decode(cfg)
        with torch.inference_mode():
            x = L.embed_tokens(self.embedding, tokens, cfg)
            if cfg.family in ATTENTION_FAMILIES:
                for i, block in enumerate(self.layers):
                    x = block.decode(x, {name: ring[i] for name, ring
                                         in state.items()}, index, cfg)
                new = state
            else:
                x, new = self._decode_recurrent(x, state, index)
            x = L.apply_norm(self.final_norm, x, cfg)
            return L.unembed(self.embedding, x, cfg), new

    def _decode_recurrent(self, x, state, index: int):
        cfg = self.cfg
        ssm, conv = [], []
        for i, block in enumerate(self.layers):
            if self._shared_at(i):
                slot = i // cfg.shared_attn_period
                x = self.shared_attn.decode(
                    x, {name: ring[slot] for name, ring
                        in state["shared_kv"].items()}, index, cfg)
            x, st = block.decode(x, {"ssm": state["ssm"][i],
                                     "conv": state["conv"][i]}, cfg)
            ssm.append(st["ssm"])
            conv.append(st["conv"])
        new = {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}
        if "shared_kv" in state:
            new["shared_kv"] = state["shared_kv"]
        return x, new


# ---------------------------------------------------------------------------
# the reference's functional names
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> LanguageModel:
    """Random init at the reference's scales from a seeded generator on the
    device (``None`` = cuda; raises without a GPU)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = L.torch_dtype(cfg.param_dtype)

    def attention_block(moe: bool = False):
        block = {"attn": L.init_attention(gen, cfg, dtype),
                 "ln1": L.maybe_init_norm(cfg.d_model, cfg, dtype, dev),
                 "ln2": L.maybe_init_norm(cfg.d_model, cfg, dtype, dev)}
        if moe:
            block["moe"] = MOE.init_moe(gen, cfg, dtype)
        else:
            block["mlp"] = L.init_mlp(gen, cfg, dtype)
        return block

    params = {"embedding": L.init_embedding(gen, cfg, dtype)}
    if cfg.family in ATTENTION_FAMILIES:
        # as the reference's init_block: every layer is MoE when
        # num_experts > 0 (moe_layer_period is not read)
        params["layers"] = [attention_block(cfg.num_experts > 0)
                            for _ in range(cfg.num_layers)]
    else:
        params["layers"] = [
            {"mamba": SSM.init_mamba2(gen, cfg, dtype),
             "norm": L.maybe_init_norm(cfg.d_model, cfg, dtype, dev)}
            for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        # Zamba2 [arXiv:2411.15242]: ONE shared attention + MLP block
        # reused every `shared_attn_period` layers
        params["shared_attn"] = attention_block()
    params["final_norm"] = L.maybe_init_norm(cfg.d_model, cfg, dtype, dev)
    # the frontends' projections last, so that a seed gives the other
    # families the same weights as before
    if cfg.modality == "vision_text":
        params["projector"] = L.init_dense(gen, cfg.frontend_dim,
                                           cfg.d_model, dtype)
    if cfg.modality == "audio":
        params["frontend_proj"] = L.init_dense(gen, cfg.frontend_dim,
                                               cfg.d_model, dtype)
        params["mask_emb"] = L._normal(gen, (cfg.d_model,), dtype)
    return LanguageModel(cfg, params)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # torch.from_numpy rejects ml_dtypes
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device=None) -> LanguageModel:
    """The reference's params pytree (``init_model``'s, layer leaves
    stacked (L, ...)), carried across as numpy arrays, as a module on
    ``device`` with the same values bit for bit: any layer tree (the MoE
    layers' router and (E, d, ff) experts too), None leaves (OLMo's norms)
    kept, the untied unembedding, the hybrid family's ``shared_attn``, the
    vlm ``projector`` and the audio ``frontend_proj`` and ``mask_emb``
    too."""
    dev = resolve_device(device)

    def conv(tree, layer=None):
        if tree is None:
            return None
        return {k: (conv(v, layer) if v is None or isinstance(v, dict)
                    else _tensor(v if layer is None else v[layer], dev))
                for k, v in tree.items()}

    params = {"embedding": conv(np_params["embedding"]),
              "layers": [conv(np_params["layers"], i)
                         for i in range(cfg.num_layers)],
              "final_norm": conv(np_params["final_norm"])}
    for name in ("shared_attn", "projector", "frontend_proj"):
        if name in np_params:
            params[name] = conv(np_params[name])
    if "mask_emb" in np_params:
        params["mask_emb"] = _tensor(np_params["mask_emb"], dev)
    return LanguageModel(cfg, params)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(model: nn.Module, cfg: ModelConfig) -> int:
    """MoE-aware, as the reference's: each expert tensor (``gate``, ``up``,
    ``down`` under ``moe``) counts at k / E of its size; every other param
    in full."""
    total = 0
    for name, p in model.named_parameters():
        keys = name.split(".")
        size = p.numel()
        if (cfg.num_experts > 0 and "moe" in keys
                and any(k in ("gate", "up", "down") for k in keys)):
            size = size * max(cfg.experts_per_token, 1) // cfg.num_experts
        total += size
    return total


def forward(model: LanguageModel, batch: dict, return_cache: bool = False,
            return_hidden: bool = False):
    return model(batch, return_cache=return_cache,
                 return_hidden=return_hidden)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None):
    """Zero decode state: for the attention families each layer's KV ring
    stacked over layers; for the recurrent families the SSM states stacked
    over layers and, for the hybrid family, the shared block's rings
    stacked over its slots. A ring has ``min(seq_len, window)`` slots
    (int8 with f16 scales under ``kv_quant``). An encoder-only config
    raises."""
    _check_family(cfg)
    _check_decode(cfg)
    dev = resolve_device(device)
    if cfg.family in ATTENTION_FAMILIES:
        return _rings(cfg, cfg.num_layers, batch, seq_len, dev)
    one = SSM.init_ssm_state(cfg, batch, L.torch_dtype(cfg.param_dtype),
                             dev)
    state = {name: t.expand((cfg.num_layers,) + t.shape).clone()
             for name, t in one.items()}
    if cfg.family == "hybrid":
        state["shared_kv"] = _rings(cfg, n_shared_slots(cfg), batch,
                                    seq_len, dev)
    return state


def _rings(cfg: ModelConfig, n: int, batch: int, seq_len: int, device):
    """``init_kv_cache``'s buffers stacked n times, zero (its shapes read
    off the meta device, which allocates nothing)."""
    one = L.init_kv_cache(cfg, batch, seq_len,
                          L.torch_dtype(cfg.param_dtype), "meta")
    return {name: torch.zeros((n,) + arr.shape, dtype=arr.dtype,
                              device=device)
            for name, arr in one.items()}


def _fill_ring(ring, got, prefill_len: int):
    """Write the last ``min(prefill_len, S_c)`` positions of ``got``
    (n, B, T, Hkv, D) into ``ring`` (n, B, S_c, Hkv, D) in place, position
    p in slot p % S_c, as decode expects."""
    size = ring.shape[2]
    take = min(prefill_len, size)
    src = got[:, :, prefill_len - take:prefill_len]
    if take == prefill_len:           # no wrap: slots [0, take)
        ring[:, :, :take] = src
    else:
        slots = torch.arange(prefill_len - take, prefill_len,
                             device=ring.device) % size
        ring[:, :, slots] = src
    return ring


def cache_from_prefill(caches, cfg: ModelConfig, batch: int, seq_len: int,
                       prefill_len: int):
    """``forward(return_cache=True)``'s caches as a decode state (the
    serving path's prefill -> decode hand-off): the K/V (the attention
    families: every layer's, for vlm over the P + T_text positions, so
    ``prefill_len`` counts the patches; hybrid: the shared slots') fill
    their rings, and the SSM states pass through. Under ``kv_quant``
    (dense, moe, vlm) the K/V are quantized per (token, head) as the
    reference's ``fill_kv_quant`` does: int8 payload with the f32 scale,
    the scale stored in f16. An encoder-only config raises."""
    _check_family(cfg)
    _check_decode(cfg)
    if cfg.family == "hybrid" and cfg.kv_quant:
        raise NotImplementedError(
            f"cache_from_prefill for the hybrid family with kv_quant "
            f"({cfg.name}) is not ported: the reference casts the prefill "
            f"K/V straight to int8 and leaves k_scale / v_scale out, so "
            f"its next decode_step fails")
    if cfg.family in ATTENTION_FAMILIES:
        with torch.inference_mode():
            rings = _rings(cfg, cfg.num_layers, batch, seq_len,
                           caches["k"].device)
            for name in ("k", "v"):
                if cfg.kv_quant:
                    payload, scale = L.quantize_kv(caches[name])
                    _fill_ring(rings[name], payload, prefill_len)
                    _fill_ring(rings[f"{name}_scale"], scale, prefill_len)
                else:
                    _fill_ring(rings[name], caches[name], prefill_len)
        return rings
    st = caches["ssm_states"]
    new = {"ssm": st["ssm"].float(),
           "conv": st["conv"].to(L.torch_dtype(cfg.param_dtype))}
    if cfg.family == "hybrid":
        with torch.inference_mode():
            rings = _rings(cfg, n_shared_slots(cfg), batch, seq_len,
                           st["ssm"].device)
            if "shared_kv" in caches:
                for name in ("k", "v"):
                    _fill_ring(rings[name], caches["shared_kv"][name],
                               prefill_len)
        new["shared_kv"] = rings
    return new


def decode_step(model: LanguageModel, tokens, state, index: int):
    return model.decode_step(tokens, state, index)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

XENT_CHUNK_THRESHOLD = 2 ** 27   # tokens * vocab above which xent streams
XENT_CHUNK_TOKENS = 512


def _nll(logits, labels):
    """Each position's -log softmax(logits)[label]: logsumexp - logit."""
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - ll


def _xent(logits, labels, mask=None):
    """Mean token cross-entropy of f32 logits (..., V) against int labels;
    with ``mask``, sum(nll * mask) / max(sum(mask), 1)."""
    nll = _nll(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _xent_chunk(h, labels, mask, w, cfg: ModelConfig):
    """One chunk's (sum of masked nll, sum of mask), the unembedding
    weight ``w`` passed in (``embed`` when tied, else ``unembed``)."""
    name = "embed" if cfg.tie_embeddings else "unembed"
    nll = _nll(L.unembed({name: w}, h, cfg), labels)
    return (nll * mask).sum(), mask.sum()


def _xent_chunked(embedding, hidden, labels, mask, cfg: ModelConfig):
    """Streamed cross-entropy: the unembedding and log-sum-exp one chunk of
    ``XENT_CHUNK_TOKENS`` positions at a time, each chunk under
    ``torch.utils.checkpoint`` so the backward recomputes its logits and
    the (T, V) logits never live whole (the reference's ``_xent_chunked``:
    the same zero padding, the same sums in chunk order)."""
    b, t, _ = hidden.shape
    c = min(XENT_CHUNK_TOKENS, t)
    pad = (-t) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    w = embedding["embed"] if cfg.tie_embeddings else embedding["unembed"]
    num = den = torch.zeros((), device=hidden.device)
    for i in range(0, t + pad, c):
        n, m = checkpoint(_xent_chunk, hidden[:, i:i + c],
                          labels[:, i:i + c], mask[:, i:i + c], w, cfg,
                          use_reentrant=False)
        num, den = num + n, den + m
    return num / torch.clamp_min(den, 1.0)


def loss_fn(model: LanguageModel, batch: dict, cfg=None):
    """Training loss for any family (the reference's ``loss_fn``): returns
    (total, {"loss", "aux_loss"}), total = loss + router_aux_weight * aux.
    Causal LM: logits[:, :-1] against ``labels`` (else ``tokens``)[:, 1:];
    vlm: the text logits ``[:, num_patches:-1]`` against ``tokens[:,
    1:]``; audio: ``targets`` where ``mask_indicator`` is set. Above
    ``XENT_CHUNK_THRESHOLD`` tokens x vocab the cross-entropy streams
    (``_xent_chunked``). The port's form takes the model, which carries
    its config; the reference's ``loss_fn(params, batch, cfg)`` over a
    params pytree raises ``NotImplementedError``."""
    if cfg is not None or not isinstance(model, LanguageModel):
        raise NotImplementedError(
            "loss_fn(params, batch, cfg), the reference's form over a "
            "params pytree, is not ported: the port's loss_fn takes "
            "(model, batch), a LanguageModel carrying its config")
    cfg = model.cfg
    n_tok = (batch["targets"] if cfg.modality == "audio"
             else batch["tokens"]).numel()
    chunked = n_tok * cfg.vocab_size > XENT_CHUNK_THRESHOLD
    out, aux, _ = model(batch, return_hidden=chunked)
    if cfg.modality == "audio":
        labels = batch["targets"]
        mask = batch["mask_indicator"].float()
    elif cfg.modality == "vision_text":
        out = out[:, cfg.num_patches:-1]
        labels = batch["tokens"][:, 1:]
        mask = None
    else:
        out = out[:, :-1]
        labels = batch.get("labels", batch["tokens"])[:, 1:]
        mask = None
    if chunked:
        if mask is None:
            mask = torch.ones(labels.shape, device=out.device)
        loss = _xent_chunked(model.embedding, out, labels, mask, cfg)
    else:
        loss = _xent(out, labels, mask)
    total = loss + f32(cfg.router_aux_weight) * aux
    return total, {"loss": loss, "aux_loss": aux}
