"""Dinkelbach's method for the fractional program P2 (Algorithm 2), numpy.

A copy of ``repro.core.dinkelbach`` for the port's host-path server.

P2: min_beta h1(beta)/h2(beta) over the box [0,1]^K — equivalently
max h2/h1. Dinkelbach's parametrization solves a sequence of subproblems

    P3: max_beta  F(beta; lam) = h2(beta) - lam * h1(beta)

updating lam <- h2(beta*)/h1(beta*) until F(beta*; lam) < tol (the paper's
stopping rule, Alg. 2 line 6).

Inner solvers for the non-concave quadratic P3:
  * "milp"      — paper-faithful piecewise-linear 0-1 MIP (core.milp),
                  branch & bound replaces CPLEX. Exact up to PWL resolution.
  * "pgd"       — projected gradient ascent, multi-restart (scalable, K=100+).
  * "exhaustive"— corner + grid enumeration (tiny K; test oracle).

`solve_p2` additionally exposes "waterfill" (core.boxqp, numpy f64), which
solves this diagonal + rank-one instance of P2 exactly through its KKT
system, and "waterfill_jnp", the f32 solver the fused round runs
(core.boxqp.waterfill_beta; the reference's name is kept).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core.power_control import P2Problem


@dataclass
class SolveResult:
    beta: np.ndarray
    objective: float          # h1/h2 (the minimized ratio)
    lam: float                # final Dinkelbach parameter = h2/h1
    iterations: int
    inner: str


def _quad_terms(prob: P2Problem, lam: float):
    """A, c, const of F(beta;lam) = beta'A beta + c'beta + const."""
    (G, g, g0), (Q, q, q0) = prob.quadratics()
    return Q - lam * G, q - lam * g, q0 - lam * g0


def _eval_F(prob: P2Problem, beta: np.ndarray, lam: float) -> float:
    return prob.h2(beta) - lam * prob.h1(beta)


# ---------------------------------------------------------------------------
# inner solvers for P3
# ---------------------------------------------------------------------------

def inner_pgd(prob: P2Problem, lam: float, restarts: int = 8,
              iters: int = 300, seed: int = 0) -> np.ndarray:
    """Projected gradient ascent on the (non-concave) quadratic over [0,1]^K."""
    A, c, _ = _quad_terms(prob, lam)
    k = prob.K
    rng = np.random.default_rng(seed)
    lip = max(np.linalg.norm(A, 2) * 2.0, 1e-9)
    step = 1.0 / lip
    starts = [np.full(k, 0.5), np.zeros(k), np.ones(k), prob.rho.copy()]
    starts += [rng.random(k) for _ in range(max(restarts - len(starts), 0))]
    best, best_val = None, -np.inf
    for x0 in starts:
        x = np.clip(x0, 0, 1)
        for _ in range(iters):
            grad = 2 * A @ x + c
            x_new = np.clip(x + step * grad, 0.0, 1.0)
            if np.max(np.abs(x_new - x)) < 1e-10:
                x = x_new
                break
            x = x_new
        val = _eval_F(prob, x, lam)
        if val > best_val:
            best, best_val = x, val
    return best


def inner_exhaustive(prob: P2Problem, lam: float, grid: int = 5) -> np.ndarray:
    """Grid enumeration over [0,1]^K — oracle for K <= 6."""
    if prob.K > 6:
        raise ValueError("exhaustive inner solver limited to K <= 6")
    pts = np.linspace(0.0, 1.0, grid)
    best, best_val = None, -np.inf
    for combo in itertools.product(pts, repeat=prob.K):
        x = np.array(combo)
        v = _eval_F(prob, x, lam)
        if v > best_val:
            best, best_val = x, v
    return best


def inner_milp(prob: P2Problem, lam: float, segments: int = 8) -> np.ndarray:
    from repro_torch.core.milp import solve_p3_milp
    A, c, const = _quad_terms(prob, lam)
    return solve_p3_milp(A, c, const, segments=segments)


_INNER: dict = {
    "pgd": inner_pgd,
    "exhaustive": inner_exhaustive,
    "milp": inner_milp,
}


# ---------------------------------------------------------------------------
# outer loop (Algorithm 2)
# ---------------------------------------------------------------------------

def dinkelbach(prob: P2Problem, inner: str = "pgd", tol: float = 1e-8,
               max_iter: int = 30,
               inner_fn: Optional[Callable] = None) -> SolveResult:
    solver = inner_fn or _INNER[inner]
    # lam_0 with F(beta; lam_0) >= 0: lam_0 = h2/h1 at any feasible point.
    beta = np.full(prob.K, 0.5)
    lam = prob.h2(beta) / max(prob.h1(beta), 1e-30)
    it = 0
    for it in range(1, max_iter + 1):
        beta_star = solver(prob, lam)
        f_val = _eval_F(prob, beta_star, lam)
        new_lam = prob.h2(beta_star) / max(prob.h1(beta_star), 1e-30)
        beta = beta_star
        if f_val < tol or abs(new_lam - lam) < 1e-14:
            lam = new_lam
            break
        lam = new_lam
    return SolveResult(beta=beta, objective=prob.objective(beta), lam=lam,
                       iterations=it, inner=inner)


SOLVERS = ("waterfill", "waterfill_jnp", "pgd", "milp", "exhaustive")


def solve_p2(prob: P2Problem, method: str = "pgd", device=None,
             **kw) -> SolveResult:
    """Entry point. method in ``SOLVERS``; "waterfill_jnp" runs the f32
    solver of the fused round on ``device`` (``None`` is the card)."""
    if method == "waterfill":
        from repro_torch.core.boxqp import solve_waterfill
        return solve_waterfill(prob)
    if method == "waterfill_jnp":
        from repro_torch.core.boxqp import solve_waterfill_jnp
        return solve_waterfill_jnp(prob, device=device)
    if method not in _INNER:
        raise ValueError(f"unknown P2 solver {method!r} (expected one of "
                         f"{SOLVERS})")
    return dinkelbach(prob, inner=method, **kw)
