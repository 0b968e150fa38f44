"""Power-control factors of eq. 25 (Section III-B), torch form.

Port of the parts of ``repro.core.power_control`` the fused round uses:

    p_k = p_max_k * ( beta_k * rho_k + (1 - beta_k) * theta_k )
    rho_k   = Omega / (s_k + Omega)
    theta_k = (cos(dw_k, w_g^t - w_g^{t-1}) + 1) / 2
"""
from __future__ import annotations

import torch

from repro_torch.device import f32


def staleness_factor(s: torch.Tensor, omega: float) -> torch.Tensor:
    """rho_k = Omega / (s_k + Omega). A true division: torch evaluates
    ``scalar / tensor`` as ``scalar * reciprocal``, which rounds twice."""
    om = f32(omega)
    return torch.full_like(s, om) / (s + om)


def similarity_factor(cos_sim: torch.Tensor) -> torch.Tensor:
    """theta_k = (cos + 1) / 2 in [0, 1]."""
    return (cos_sim + 1.0) / 2.0


def power_from_beta(beta, rho, theta, p_max):
    """Eq. (25), clipped to [0, p_max] (cond. 7). All (K,) tensors."""
    p = p_max * (beta * rho + (1.0 - beta) * theta)
    return torch.minimum(torch.clamp_min(p, 0.0), p_max)


def p2_constants(smooth_l: float, eps_bound: float, k: int, model_dim: int,
                 sigma_n2: float):
    """Theorem-1 constants of P2: c1 = L eps^2 K (term-d scale) and
    c0 = 2 L d sigma_n^2 (term-e numerator)."""
    return smooth_l * eps_bound ** 2 * k, 2.0 * smooth_l * model_dim * sigma_n2
