"""Model assembly, torch form: the ``ssm`` family (mamba2-370m).

Port of the SSM branch of ``repro.models.transformer``. The reference
stacks its layers along a leading L axis and scans them; the port keeps
one ``nn.Module`` per block in a ``ModuleList`` and loops. Caches and
decode states keep the reference's stacked layout and names:
``{"ssm": (L, B, H, P, N) f32, "conv": (L, B, K-1, C)}``.

The other families (dense, moe, hybrid, vlm, audio) and ``loss_fn`` are
not ported yet and raise ``NotImplementedError`` naming themselves.
Params hold no gradient: the port serves, it does not train yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig


def _pdict(params: Optional[dict]) -> Optional[nn.ParameterDict]:
    if params is None:
        return None
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"port runs the 'ssm' family")


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


class LanguageModel(nn.Module):
    """Token embedding, L Mamba2 blocks, final norm and the (tied)
    unembedding, built from params in the reference's structure:
    ``{"embedding": {...}, "layers": [block, ...], "final_norm": ...}``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embedding = _pdict(params["embedding"])
        self.layers = nn.ModuleList(MambaBlock(b["mamba"], b["norm"])
                                    for b in params["layers"])
        self.final_norm = _pdict(params["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.embedding["embed"].device

    def forward(self, tokens, return_cache: bool = False,
                return_hidden: bool = False):
        """Full-sequence forward over (B, T) tokens. Returns (logits
        (B, T, V) f32 | hidden (B, T, d), aux 0.0, caches | None), caches
        being ``{"ssm_states": {"ssm", "conv"}}`` stacked over layers."""
        cfg = self.cfg
        x = L.embed_tokens(self.embedding, tokens, cfg)
        ssm, conv = [], []
        for block in self.layers:
            x, state = block(x, cfg)
            if return_cache:
                ssm.append(state["ssm"])
                conv.append(state["conv"])
        x = L.apply_norm(self.final_norm, x, cfg)
        caches = None
        if return_cache:
            caches = {"ssm_states": {"ssm": torch.stack(ssm),
                                     "conv": torch.stack(conv)}}
        aux = torch.zeros((), device=x.device)
        if return_hidden:
            return x, aux, caches
        return L.unembed(self.embedding, x, cfg), aux, caches

    def init_decode_state(self, batch: int, seq_len: int):
        return init_decode_state(self.cfg, batch, seq_len, self.device)

    def cache_from_prefill(self, caches, batch: int, seq_len: int,
                           prefill_len: int):
        return cache_from_prefill(caches, self.cfg, batch, seq_len,
                                  prefill_len)

    def decode_step(self, tokens, state, index):
        """One-token decode. tokens: (B, 1) int; index: tokens so far
        (unused by the SSM family). Returns (logits (B, 1, V) f32, new
        state)."""
        cfg = self.cfg
        x = L.embed_tokens(self.embedding, tokens, cfg)
        ssm, conv = [], []
        for i, block in enumerate(self.layers):
            x, st = block.decode(x, {"ssm": state["ssm"][i],
                                     "conv": state["conv"][i]}, cfg)
            ssm.append(st["ssm"])
            conv.append(st["conv"])
        x = L.apply_norm(self.final_norm, x, cfg)
        logits = L.unembed(self.embedding, x, cfg)
        return logits, {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}


# ---------------------------------------------------------------------------
# the reference's functional names
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> LanguageModel:
    """Random init at the reference's scales from a seeded generator on the
    device (``None`` = cuda; raises without a GPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = L.torch_dtype(cfg.param_dtype)
    params = {"embedding": L.init_embedding(gen, cfg, dtype),
              "layers": [{"mamba": SSM.init_mamba2(gen, cfg, dtype),
                          "norm": L.maybe_init_norm(cfg.d_model, cfg, dtype,
                                                    dev)}
                         for _ in range(cfg.num_layers)],
              "final_norm": L.maybe_init_norm(cfg.d_model, cfg, dtype, dev)}
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
    ``device`` with the same values bit for bit."""
    dev = resolve_device(device)

    def conv(tree):
        if tree is None:
            return None
        return {k: _tensor(v, dev) for k, v in tree.items()}

    stacked = np_params["layers"]
    layers = [{"mamba": {k: _tensor(v[i], dev)
                         for k, v in stacked["mamba"].items()},
               "norm": (None if stacked.get("norm") is None else
                        {k: _tensor(v[i], dev)
                         for k, v in stacked["norm"].items()})}
              for i in range(cfg.num_layers)]
    return LanguageModel(cfg, {"embedding": conv(np_params["embedding"]),
                               "layers": layers,
                               "final_norm": conv(np_params["final_norm"])})


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(model: LanguageModel, cfg: ModelConfig) -> int:
    """All params are active outside MoE (the only family ported)."""
    if cfg.num_experts > 0:
        raise NotImplementedError("active_param_count for MoE is not "
                                  "ported yet")
    return param_count(model)


def forward(model: LanguageModel, batch: dict, return_cache: bool = False,
            return_hidden: bool = False):
    return model(batch["tokens"], return_cache=return_cache,
                 return_hidden=return_hidden)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None):
    """Zero SSM states stacked over layers (``seq_len`` sizes the KV ring
    of the attention families, which are not ported)."""
    _check_family(cfg)
    one = SSM.init_ssm_state(cfg, batch, L.torch_dtype(cfg.param_dtype),
                             resolve_device(device))
    return {name: t.expand((cfg.num_layers,) + t.shape).clone()
            for name, t in one.items()}


def cache_from_prefill(caches, cfg: ModelConfig, batch: int, seq_len: int,
                       prefill_len: int):
    """``forward(return_cache=True)``'s caches as a decode state: the SSM
    states pass through (the serving path's prefill -> decode hand-off)."""
    _check_family(cfg)
    st = caches["ssm_states"]
    return {"ssm": st["ssm"].float(),
            "conv": st["conv"].to(L.torch_dtype(cfg.param_dtype))}


def decode_step(model: LanguageModel, tokens, state, index):
    return model.decode_step(tokens, state, index)


def loss_fn(*args, **kwargs):
    raise NotImplementedError("loss_fn is not ported yet: the port serves "
                              "the LM zoo and does not train it")
