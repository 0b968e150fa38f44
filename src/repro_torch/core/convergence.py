"""Theorem-1 convergence-bound terms (eqs. 21-23), numpy in float64.

A copy of ``repro.core.convergence`` for the port: (i) the learning-rate
regime check A^r < 1 before a run, (ii) the controllable gap terms
(d)+(e) that the power control minimizes, and (iii) the bound benchmark
(``repro_torch.bench.bound``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BoundConstants:
    """Assumption constants. Defaults follow Section IV-A (L=10, M=5)."""
    smooth_l: float = 10.0      # L   (Assumption 1)
    zeta: float = 1.0           # data-heterogeneity bound (Assumption 2)
    delta: float = 0.01         # staleness inner-product bound (Assumption 3)
    epsilon: float = 0.05       # ||w^{r-n} - w^r|| bound     (Assumption 3)
    vartheta: float = 1.0       # local gradient-change bound  (Assumption 3)
    sigma: float = 1.0          # SGD variance bound           (Assumption 4)
    eta: float = 0.01           # learning rate
    local_steps: int = 5        # M


def contraction_A(c: BoundConstants) -> float:
    """A^r (eq. 22). Must be < 1 for the recursion to contract; ``inf``
    when the denominator 1 - 2 eta^2 M^2 L^2 is not positive."""
    l, eta, m, vth = c.smooth_l, c.eta, c.local_steps, c.vartheta
    denom = 1.0 - 2.0 * eta ** 2 * m ** 2 * l ** 2
    if denom <= 0:
        return np.inf
    return (1.0 + 2.0 * l * c.delta - l * eta * m
            + 8.0 * l ** 2 * eta ** 2 * m * vth ** 2
            + (eta * l ** 2 + 4.0 * m * eta ** 2 * l ** 3)
            * 8.0 * l * eta ** 2 * m ** 3 * vth ** 2 / denom)


def gap_G(c: BoundConstants, alphas: np.ndarray, sum_bp: float,
          model_dim: int, sigma_n2: float) -> dict:
    """G^r terms (a)-(e) of eq. (23). alphas: aggregation weights (K,),
    sum_bp = sum_k b_k p_k, model_dim = d."""
    l, eta, m = c.smooth_l, c.eta, c.local_steps
    denom = 1.0 - 2.0 * eta ** 2 * m ** 2 * l ** 2
    k = len(alphas)
    term_a = (2 * eta * m + 8 * l * eta * m ** 2
              + 4 * eta ** 2 * m ** 3 * l ** 2
              * (eta * l ** 2 + 4 * m * eta ** 2 * l ** 3) / denom) * c.zeta
    term_b = 2 * eta * m * l ** 2 * c.epsilon ** 2
    term_c = (2 * eta ** 2 * l * m ** 2
              + (eta * l ** 2 + 4 * m * eta ** 2 * l ** 3)
              * eta ** 2 * m ** 3 / denom) * c.sigma ** 2
    term_d = l * c.epsilon ** 2 * k * float(np.sum(alphas ** 2))
    term_e = 2.0 * l * model_dim * sigma_n2 / max(sum_bp, 1e-30) ** 2
    return {"a": term_a, "b": term_b, "c": term_c, "d": term_d, "e": term_e,
            "total": term_a + term_b + term_c + term_d + term_e,
            "controllable": term_d + term_e}


def bound_trajectory(c: BoundConstants, g_terms: list,
                     f0_gap: float) -> np.ndarray:
    """Eq. (21): gap_R = prod A * gap_0 + sum_r (prod_{i>r} A) G^r."""
    a = contraction_A(c)
    gaps = [f0_gap]
    for g in g_terms:
        gaps.append(a * gaps[-1] + g)
    return np.array(gaps)
