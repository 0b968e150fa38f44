"""Exact water-filling solve of P2, torch form.

Port of ``repro.core.boxqp.waterfill_beta_jnp``. With t_k = b_k p_k(beta_k)
confined to [lo_k, hi_k], P2 is min_t (c1 sum t^2 + c0) / (sum t)^2, whose
minimizer is t_k = clip(tau, lo_k, hi_k) for one scalar tau: a 4096-point
grid scan over tau, then 60 golden-section steps. Every quantity stays an
f32 tensor on the caller's device (no host sync, no data-dependent control
flow), matching the reference's x64-off arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import f32

# pick the LOWEST-index grid cell within this relative band of the minimum:
# the objective is flat near its optimum, so a bare argmin would depend on
# the reduction order of the sums (reference: core/boxqp.py)
WATERFILL_TIE_RTOL = 32 * float(np.finfo(np.float32).eps)

_GOLDEN = f32((np.sqrt(5.0) - 1.0) / 2.0)


def _grid(n: int, device) -> torch.Tensor:
    """The reference's ``jnp.linspace(0, 1, n)`` in f32, bit for bit: XLA
    evaluates i / (n - 1) as i * f32(1 / (n - 1)) and pins the endpoint.
    Built from device ops only (assigning a Python number into a CUDA
    tensor copies it from the host and synchronizes)."""
    step = float(np.float32(1.0) / np.float32(n - 1))
    head = torch.arange(n - 1, dtype=torch.float32, device=device) * step
    return torch.cat([head, torch.ones(1, dtype=torch.float32,
                                       device=device)])


def waterfill_beta(rho, theta, p_max, b, c1: float, c0: float,
                   grid: int = 4096, refine: int = 60):
    """Returns (beta (K,), objective scalar), both f32 tensors.

    With no active client (b all zero) beta is arbitrary and the objective
    degenerate; the caller's zero-uploader guard makes the round a no-op."""
    c1, c0 = f32(c1), f32(c0)
    p0 = torch.minimum(torch.clamp_min(p_max * theta, 0.0), p_max)
    p1 = torch.minimum(torch.clamp_min(p_max * rho, 0.0), p_max)
    lo = torch.minimum(p0, p1) * b
    hi = torch.maximum(p0, p1) * b
    active = b > 0
    any_active = active.any()
    inf = torch.full_like(lo, float("inf"))
    tau_lo = torch.where(any_active, torch.where(active, lo, inf).min(),
                         torch.zeros_like(lo[0]))
    tau_hi = torch.where(any_active, torch.where(active, hi, -inf).max(),
                         torch.ones_like(hi[0]))

    def ratio(t):                       # (..., K) -> (...)
        s = t.sum(-1)
        return (c1 * (t * t).sum(-1) + c0) / torch.clamp_min(s * s, f32(1e-30))

    taus = tau_lo + (tau_hi - tau_lo) * _grid(grid, lo.device)
    vals = ratio(torch.clamp(taus[:, None], lo[None, :], hi[None, :])
                 * b[None, :])
    thresh = vals.min() * f32(1.0 + WATERFILL_TIE_RTOL)
    # argmax returns the FIRST maximal index; it takes no bool tensors
    j = (vals <= thresh).to(torch.uint8).argmax().reshape(1)
    a = taus.index_select(0, torch.clamp_min(j - 1, 0))[0]
    bnd = taus.index_select(0, torch.clamp_max(j + 1, grid - 1))[0]
    for _ in range(refine):
        step = _GOLDEN * (bnd - a)
        m = torch.stack([bnd - step, a + step])           # (m1, m2)
        f = ratio(torch.clamp(m[:, None], lo[None, :], hi[None, :])
                  * b[None, :])
        left = f[0] < f[1]
        a, bnd = torch.where(left, a, m[0]), torch.where(left, m[1], bnd)
    tau = (a + bnd) / 2.0
    t = torch.clamp(tau, lo, hi) * b
    # recover beta from t = pm (theta + (rho - theta) beta)
    dcoef = p_max * (rho - theta)
    interior = dcoef.abs() > f32(1e-12)
    beta = torch.where(interior,
                       (t - p_max * theta)
                       / torch.where(interior, dcoef, torch.ones_like(dcoef)),
                       torch.full_like(dcoef, 0.5))
    beta = torch.clamp(beta, 0.0, 1.0)
    p = torch.minimum(
        torch.clamp_min(p_max * (beta * rho + (1.0 - beta) * theta), 0.0),
        p_max) * b
    return beta, ratio(p)
