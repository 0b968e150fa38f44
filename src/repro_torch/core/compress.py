"""Analog-payload compression of the cohort plane, torch form.

Port of ``repro.core.compress``: per-row magnitude top-k supports, the
gather and scatter between an (m, d) plane and its (m, s) compressed form,
the exact error-feedback residual, and int8 slot storage with a stochastic
rounding dither.

Two things differ from the reference on purpose:

- ``topk_support`` is a stable descending sort, not ``torch.topk``.
  ``lax.top_k`` puts the lower index first among equal values, and MLP
  deltas tie often (exact zeros from dead ReLU units); ``torch.topk``
  promises no order, and the order of a row's indices also fixes the
  summation order of the compressed stats.
- The random draws are injected: the randmask support is a draw of the
  round's draw source (``repro_torch.fl.runtime``), and
  ``quantize_int8_stochastic`` takes the (m, s) dither uniforms as an
  argument instead of a key.
"""
from __future__ import annotations

import torch

from repro_torch.device import f32

INT8_MAX = 127.0


def topk_support(a: torch.Tensor, s: int) -> torch.Tensor:
    """(m, s) int32 indices of the s largest-|.| entries of each row, in
    descending order with ties to the lower index (``lax.top_k``'s)."""
    order = torch.sort(a.abs(), dim=1, descending=True, stable=True).indices
    return order[:, :s].to(torch.int32)


def gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(m, s) values of ``a`` at the per-row support ``idx``."""
    return torch.gather(a, 1, idx.long())


def scatter_rows(vals: torch.Tensor, idx: torch.Tensor, d: int):
    """Decompress (m, s) values to (m, d) rows: zeros off the support,
    duplicate indices summed (a support holds none)."""
    out = torch.zeros((vals.shape[0], d), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(1, idx.long(), vals)


def ef_residual(comp: torch.Tensor, idx: torch.Tensor, v_hat: torch.Tensor):
    """Exact error-feedback residual: ``comp`` with ``v_hat`` subtracted
    in place on the support, so ``residual + scatter_rows(v_hat, idx)``
    rebuilds ``comp`` bit for bit (on-support entries cancel to 0.0 when
    ``v_hat`` is the untouched gather)."""
    return comp.clone().scatter_add_(1, idx.long(), -v_hat)


def sparsify(e: torch.Tensor, s: int):
    """Re-sparsify a dense (m, d) residual to carry width: its top s by
    |.|. Returns ((m, s) values, (m, s) int32 indices)."""
    idx = topk_support(e, s)
    return gather_rows(e, idx), idx


def quantize_int8_stochastic(v: torch.Tensor, u: torch.Tensor):
    """Per-row absmax int8 with an unbiased stochastic-rounding dither:
    ``q = clip(floor(v / scale + u), -127, 127)`` with ``u`` the (m, s)
    U[0, 1) draws, so E[q * scale] = v. Returns ((m, s) int8, (m,) f32
    scale)."""
    v32 = v.float()
    amax = v32.abs().amax(dim=1)
    scale = torch.clamp_min(amax / f32(INT8_MAX), f32(1e-30))
    q = torch.floor(v32 / scale[:, None] + u.float())
    q = torch.clamp(q, -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 reconstruction of ``quantize_int8_stochastic``'s output."""
    return q.float() * scale[:, None]
