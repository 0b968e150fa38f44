"""Power-control factors of eq. 25 (Section III-B), torch form.

Port of ``repro.core.power_control``:

    p_k = p_max_k * ( beta_k * rho_k + (1 - beta_k) * theta_k )
    rho_k   = Omega / (s_k + Omega)
    theta_k = (cos(dw_k, w_g^t - w_g^{t-1}) + 1) / 2

with the per-client reductions (``client_sq_norms``, ``client_dots``,
``global_sq_norm``, ``cosine_similarity``) as torch ops on the device and
the P2 problem data (``P2Problem``, ``build_p2``) in numpy f64 for the
host solvers. The reductions take a params dict of client-stacked
(K, ...) leaves, whose per-leaf partials are summed in the reference's
leaf order; a raveled (K, d) plane is the one-leaf tree and runs the one
contraction it always did. The reference's TP forms are not ported.
``cosine_similarity(use_kernel=True)`` is the one entry point of the
``cosine_partials`` kernel (``repro_torch.kernels.ops.cosine_sim``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import f32
from repro_torch.kernels.ops import cosine_sim
from repro_torch.tree import leaf2d, tree_leaves


def staleness_factor(s: torch.Tensor, omega: float) -> torch.Tensor:
    """rho_k = Omega / (s_k + Omega). A true division: torch evaluates
    ``scalar / tensor`` as ``scalar * reciprocal``, which rounds twice."""
    om = f32(omega)
    return torch.full_like(s, om) / (s + om)


def similarity_factor(cos_sim: torch.Tensor) -> torch.Tensor:
    """theta_k = (cos + 1) / 2 in [0, 1]."""
    return (cos_sim + 1.0) / 2.0


def _sum_leaves(parts):
    """Per-leaf partials summed left to right, in leaf order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def client_sq_norms(stacked) -> torch.Tensor:
    """(K,) per-client ||x_k||^2 of a (K, d) plane, as the reference's
    ``einsum("kd,kd->k")`` (an XLA contraction there, a torch one here),
    or of a params dict of (K, ...) leaves, summed across leaves."""
    return _sum_leaves([torch.einsum("kd,kd->k", l, l)
                        for l in map(leaf2d, tree_leaves(stacked))])


def client_dots(stacked, vec) -> torch.Tensor:
    """(K,) per-client <x_k, vec>; on params dicts, summed across the
    leaves of ``stacked`` against the matching leaves of ``vec``."""
    return _sum_leaves([leaf2d(l) @ g.reshape(-1) for l, g
                        in zip(tree_leaves(stacked), tree_leaves(vec))])


def global_sq_norm(vec) -> torch.Tensor:
    """Scalar ||vec||^2 of a vector or of every leaf of a params dict."""
    return _sum_leaves([(g * g).sum() for g in tree_leaves(vec)])


def cosine_similarity(deltas, global_dir, use_kernel: bool = False,
                      eps: float = 1e-12):
    """(K,) cos(dw_k, g) of a (K, d) delta plane against a (d,) direction,
    or of a params dict of stacked deltas against the matching direction
    dict. ``use_kernel`` takes the reference's kernel route (raveled
    only), whose finishing formula clamps differently
    (``repro_torch.kernels.ops.cosine_sim``). ``clamp_min`` passes NaN
    through, so a corrupt row's cosine stays NaN for the screen."""
    if use_kernel:
        return cosine_sim(deltas, global_dir, eps=eps)
    eps = f32(eps)
    num = client_dots(deltas, global_dir)
    den = torch.sqrt(torch.clamp_min(client_sq_norms(deltas), eps)
                     * torch.clamp_min(global_sq_norm(global_dir), eps))
    return num / den


def power_from_beta(beta, rho, theta, p_max):
    """Eq. (25), clipped to [0, p_max] (cond. 7). All (K,) tensors."""
    p = p_max * (beta * rho + (1.0 - beta) * theta)
    return torch.minimum(torch.clamp_min(p, 0.0), p_max)


def p2_constants(smooth_l: float, eps_bound: float, k: int, model_dim: int,
                 sigma_n2: float):
    """Theorem-1 constants of P2: c1 = L eps^2 K (term-d scale) and
    c0 = 2 L d sigma_n^2 (term-e numerator)."""
    return smooth_l * eps_bound ** 2 * k, 2.0 * smooth_l * model_dim * sigma_n2


@dataclass(frozen=True)
class P2Problem:
    """Quadratic-ratio data of P2 (numpy f64, solver side)."""
    rho: np.ndarray      # (K,)
    theta: np.ndarray    # (K,)
    p_max: np.ndarray    # (K,)
    b: np.ndarray        # (K,) in {0, 1}
    c1: float            # L eps^2 K           (term-d scale)
    c0: float            # 2 L d sigma_n^2     (term-e numerator)

    @property
    def K(self) -> int:
        return len(self.rho)

    def power(self, beta: np.ndarray) -> np.ndarray:
        p = self.p_max * (beta * self.rho + (1 - beta) * self.theta)
        return np.clip(p, 0.0, self.p_max)

    def h1(self, beta: np.ndarray) -> float:
        p = self.power(beta) * self.b
        return float(self.c1 * np.sum(p * p) + self.c0)

    def h2(self, beta: np.ndarray) -> float:
        p = self.power(beta) * self.b
        s = np.sum(p)
        return float(s * s)

    def objective(self, beta: np.ndarray) -> float:
        """P2: h1/h2 (minimize); the P3 form maximizes h2/h1."""
        return self.h1(beta) / max(self.h2(beta), 1e-30)

    def quadratics(self):
        """h1 = b'Gb + g'b + g0 and h2 = b'Qb + q'b + q0 over beta
        (unclipped): the paper's G, g, g0, Q, q, q0."""
        pm, th, d = self.p_max, self.theta, (self.rho - self.theta)
        m = self.b.astype(float)
        # p_k = pm_k (th_k + d_k beta_k); active entries only
        A = pm * d * np.sqrt(m)            # sqrt-mask keeps G diagonal PSD
        Bc = pm * th * np.sqrt(m)
        G = self.c1 * np.diag(A * A)
        g = 2 * self.c1 * A * Bc
        g0 = self.c1 * float(Bc @ Bc) + self.c0
        u = pm * d * m
        v = pm * th * m
        Q = np.outer(u, u)
        q = 2 * float(np.sum(v)) * u
        q0 = float(np.sum(v)) ** 2
        return (G, g, g0), (Q, q, q0)


def build_p2(rho, theta, p_max, b, *, smooth_l: float, eps_bound: float,
             model_dim: int, sigma_n2: float) -> P2Problem:
    """P2 from the Theorem-1 constants c1 = L eps^2 K, c0 = 2 L d sigma^2."""
    rho = np.asarray(rho, float)
    c1, c0 = p2_constants(smooth_l, eps_bound, len(rho), model_dim, sigma_n2)
    return P2Problem(rho=rho, theta=np.asarray(theta, float),
                     p_max=np.asarray(p_max, float), b=np.asarray(b, float),
                     c1=c1, c0=c0)
