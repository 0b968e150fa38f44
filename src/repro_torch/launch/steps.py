"""The serving steps on one device: the bodies of the reference's
``make_prefill_step`` and ``make_serve_step`` (``repro/launch/steps.py``).

The reference jits them over a mesh with explicit shardings; the port runs
them eagerly on one device under ``torch.inference_mode()``. The mesh and
the shardings belong to the multi-device slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def prefill(model, batch):
    """Forward over the prompt batch (``tokens``; vlm: ``patch_embeds``
    too; audio: ``frame_feats`` and an optional ``mask_indicator``):
    ``(logits (B, 1, V) of the last position, caches)``, the caches None
    for an encoder-only config. Only the last position is unembedded; the
    logits are the reference's ``logits[:, -1:, :]``."""
    cfg = model.cfg
    with torch.inference_mode():
        hidden, _, caches = model(batch, return_cache=cfg.supports_decode,
                                  return_hidden=True)
        return L.unembed(model.embedding, hidden[:, -1:], cfg), caches


def serve(model, tokens, state, index):
    """One greedy decode step: ``(next tokens (B, 1) int32, new state)``."""
    with torch.inference_mode():
        logits, new_state = model.decode_step(tokens, state, index)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_state
