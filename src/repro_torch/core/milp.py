"""Paper-faithful inner solver for P3 (a copy of ``repro.core.milp``, numpy
and scipy): piecewise-linear approximation of the
non-concave quadratic -> 0-1 linear MIP (paper eqs. 28-39), solved by a
pure-python branch & bound over scipy HiGHS LP relaxations (replacing the
paper's IBM CPLEX).

Formulation. P3 is max_beta beta'A beta + c'beta + const over [0,1]^K.
Eigendecompose A = V N V' (paper's M_2' S M_2 = N step), z = V'beta, so the
quadratic separates: sum_i n_i z_i^2 + (V c)' z. Each z_i^2 is approximated
on [zlo_i, zhi_i] with `segments` chords via the lambda-method (paper's
gamma_ij, eqs. 34-37):

    z_i = sum_j gamma_ij zbar_ij,  zsq_i = sum_j gamma_ij zbar_ij^2,
    sum_j gamma_ij = 1, gamma >= 0.

For eigendirections with n_i < 0 (concave contribution to a maximization)
adjacency is automatic. For n_i > 0 (convex), binaries y_ij force gamma
support onto one segment (paper's c_ij constraints, eq. 38) — these are the
0-1 variables of problem (39).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import linprog


@dataclass(order=True)
class _Node:
    bound: float
    fixed: dict = field(compare=False)


def _build_lp(A_eig_vals, V, c, k, segments, zlo, zhi):
    """Variable layout: for each i in [k]: gamma_i1..gamma_i,S+1, then for
    convex dims: y_i1..y_iS. Returns coefficient builders."""
    s = segments
    n_gamma = k * (s + 1)
    convex = [i for i in range(k) if A_eig_vals[i] > 1e-12]
    y_offset = {i: n_gamma + j * s for j, i in enumerate(convex)}
    n_var = n_gamma + len(convex) * s
    zbar = np.stack([np.linspace(zlo[i], zhi[i], s + 1) for i in range(k)])
    return n_gamma, convex, y_offset, n_var, zbar


def solve_p3_milp(A: np.ndarray, c: np.ndarray, const: float,
                  segments: int = 8, max_nodes: int = 2000) -> np.ndarray:
    """Maximize beta'A beta + c'beta + const over [0,1]^K via PWL 0-1 MIP."""
    k = A.shape[0]
    vals, V = np.linalg.eigh((A + A.T) / 2.0)      # A = V diag(vals) V'
    cz = V.T @ c                                    # linear term in z
    # z bounds: z_i = sum_j V_ji beta_j, beta in [0,1]
    zlo = np.minimum(V, 0).sum(axis=0)
    zhi = np.maximum(V, 0).sum(axis=0)

    n_gamma, convex, y_offset, n_var, zbar = _build_lp(
        vals, V, c, k, segments, zlo, zhi)
    s = segments

    def gidx(i, j):
        return i * (s + 1) + j

    # objective (maximize -> linprog minimizes negative)
    obj = np.zeros(n_var)
    for i in range(k):
        for j in range(s + 1):
            obj[gidx(i, j)] = vals[i] * zbar[i, j] ** 2 + cz[i] * zbar[i, j]

    # equality: sum_j gamma_ij = 1 per i; plus sum_j y_ij = 1 per convex i
    a_eq_rows, b_eq = [], []
    for i in range(k):
        row = np.zeros(n_var)
        row[gidx(i, 0):gidx(i, s + 1)] = 1.0
        a_eq_rows.append(row)
        b_eq.append(1.0)
    for i in convex:
        row = np.zeros(n_var)
        row[y_offset[i]:y_offset[i] + s] = 1.0
        a_eq_rows.append(row)
        b_eq.append(1.0)

    # inequality: box on beta = V z -> 0 <= sum_i V_ji z_i <= 1 for each j.
    a_ub_rows, b_ub = [], []
    for jrow in range(k):
        row = np.zeros(n_var)
        for i in range(k):
            for j in range(s + 1):
                row[gidx(i, j)] += V[jrow, i] * zbar[i, j]
        a_ub_rows.append(row.copy());  b_ub.append(1.0)     # beta_j <= 1
        a_ub_rows.append(-row);        b_ub.append(0.0)     # beta_j >= 0
    # adjacency (paper eq. 38): gamma_i1<=y_i1; gamma_ij<=y_{ij-1}+y_ij; ...
    for i in convex:
        for j in range(s + 1):
            row = np.zeros(n_var)
            row[gidx(i, j)] = 1.0
            if j > 0:
                row[y_offset[i] + j - 1] = -1.0
            if j < s:
                row[y_offset[i] + j] = -1.0
            a_ub_rows.append(row)
            b_ub.append(0.0)

    a_eq = np.array(a_eq_rows); b_eq = np.array(b_eq)
    a_ub = np.array(a_ub_rows); b_ub = np.array(b_ub)
    binaries = [y_offset[i] + j for i in convex for j in range(s)]

    def lp_relax(fixed: dict) -> Tuple[Optional[np.ndarray], float]:
        bounds = [(0.0, 1.0)] * n_var
        for idx, v in fixed.items():
            bounds[idx] = (v, v)
        res = linprog(-obj, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                      bounds=bounds, method="highs")
        if not res.success:
            return None, -np.inf
        return res.x, -res.fun

    def extract_beta(x) -> np.ndarray:
        z = np.array([sum(x[gidx(i, j)] * zbar[i, j] for j in range(s + 1))
                      for i in range(k)])
        return np.clip(V @ z, 0.0, 1.0)

    def true_obj(beta) -> float:
        return float(beta @ A @ beta + c @ beta + const)

    # branch & bound (best-first on LP bound)
    x0, bound0 = lp_relax({})
    if x0 is None:
        return np.full(k, 0.5)
    best_beta = extract_beta(x0)
    best_val = true_obj(best_beta)
    heap: List[_Node] = [_Node(-bound0, {})]
    nodes = 0
    while heap and nodes < max_nodes:
        node = heapq.heappop(heap)
        nodes += 1
        x, bound = lp_relax(node.fixed)
        if x is None or bound + const <= best_val + 1e-12:
            continue
        frac = [(abs(x[b] - round(x[b])), b) for b in binaries
                if b not in node.fixed]
        frac = [(f, b) for f, b in frac if f > 1e-6]
        cand = extract_beta(x)
        cv = true_obj(cand)
        if cv > best_val:
            best_val, best_beta = cv, cand
        if not frac:
            continue
        _, bvar = max(frac)
        for v in (0.0, 1.0):
            fixed = dict(node.fixed); fixed[bvar] = v
            heapq.heappush(heap, _Node(-bound, fixed))
    return best_beta
