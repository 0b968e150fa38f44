"""Exact water-filling solve of P2: the numpy host solver and the f32 torch
solver.

``solve_waterfill`` is a numpy f64 copy of the reference's host solver
(dense (grid, K) evaluation, or sorted prefix sums from
``PREFIX_K_THRESHOLD`` clients up). ``waterfill_beta`` ports
``repro.core.boxqp.waterfill_beta_jnp``, and ``solve_waterfill_jnp`` wraps
it for the host-path server under the reference's solver name. With t_k = b_k p_k(beta_k)
confined to [lo_k, hi_k], P2 is min_t (c1 sum t^2 + c0) / (sum t)^2, whose
minimizer is t_k = clip(tau, lo_k, hi_k) for one scalar tau: a 4096-point
grid scan over tau, then 60 golden-section steps. Every quantity stays an
f32 tensor on the caller's device (no host sync, no data-dependent control
flow), matching the reference's x64-off arithmetic.

The objective is flat near its optimum, so the two solvers stay on one
bracket only if they round alike. XLA:CPU compiles the reference's
multiply-adds into fused multiply-adds (one rounding): the grid points,
the golden-section points, ``c1 * sum t^2 + c0``, the sum of squares
(accumulated element by element) and eq. 25's ``beta*rho + (1-beta)*theta``.
``_fma`` rounds each of them once here too, on every device, and for
K <= ``SEQUENTIAL_K_MAX`` the sums over K run in the reference's
sequential order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dinkelbach import SolveResult
from repro_torch.core.power_control import P2Problem
from repro_torch.device import f32, resolve_device

# pick the LOWEST-index grid cell within this relative band of the minimum:
# the objective is flat near its optimum, so a bare argmin would depend on
# the reduction order of the sums (reference: core/boxqp.py)
WATERFILL_TIE_RTOL = 32 * float(np.finfo(np.float32).eps)

_GOLDEN = f32((np.sqrt(5.0) - 1.0) / 2.0)

# up to this many clients the reference's sums over K run one element after
# another (each square accumulated by an FMA); that order was bit-equal to
# the reference's at K in {4, 8, 16, 24} and at none of 40 instances at
# K = 32, where XLA vectorizes the sums. Above it the port sums in torch's
# order.
SEQUENTIAL_K_MAX = 24


def _fma(a, b, c):
    """round_f32(a * b + c) with one rounding, for f32 tensors or f32-valued
    Python floats: the product of two f32 values is exact in f64, the f64
    sum is rounded to f32 (a double rounding that differs from a true FMA
    only at an f64 tie)."""
    def wide(x):
        return x.double() if isinstance(x, torch.Tensor) else x
    return (wide(a) * wide(b) + wide(c)).float()


def _ksum(t):
    """sum over the last (client) axis, in the reference's order."""
    if t.shape[-1] > SEQUENTIAL_K_MAX:
        return t.sum(-1)
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def _ksum_sq(t):
    """sum of squares over the last axis, FMA-accumulated in order."""
    if t.shape[-1] > SEQUENTIAL_K_MAX:
        return (t * t).sum(-1)
    acc = torch.zeros_like(t[..., 0])
    for i in range(t.shape[-1]):
        acc = _fma(t[..., i], t[..., i], acc)
    return acc


def _t_bounds(prob: P2Problem):
    """Interval of t_k = b_k p_k(beta_k) as beta_k sweeps [0, 1]."""
    p0 = np.clip(prob.p_max * prob.theta, 0, prob.p_max)   # beta = 0
    p1 = np.clip(prob.p_max * prob.rho, 0, prob.p_max)     # beta = 1
    lo = np.minimum(p0, p1) * prob.b
    hi = np.maximum(p0, p1) * prob.b
    return lo, hi


class _PrefixEvaluator:
    """O(log K) per-tau evaluation of S1(tau) = sum_k clip(tau, lo, hi) and
    S2(tau) = its sum of squares over the active clients: lo/hi sorted once
    and prefix-summed, so every tau is three searchsorted lookups

        S1(tau) = sum_{hi_k < tau} hi_k + sum_{lo_k > tau} lo_k
                  + tau * #{lo_k <= tau <= hi_k}.
    """

    def __init__(self, lo: np.ndarray, hi: np.ndarray):
        self.lo_s = np.sort(lo)
        self.hi_s = np.sort(hi)
        self.n = len(lo)
        self.cum_lo = np.concatenate([[0.0], np.cumsum(self.lo_s)])
        self.cum_lo2 = np.concatenate([[0.0], np.cumsum(self.lo_s ** 2)])
        self.cum_hi = np.concatenate([[0.0], np.cumsum(self.hi_s)])
        self.cum_hi2 = np.concatenate([[0.0], np.cumsum(self.hi_s ** 2)])

    def sums(self, taus):
        taus = np.asarray(taus, float)
        i_hi = np.searchsorted(self.hi_s, taus, side="left")   # hi_k < tau
        i_lo = np.searchsorted(self.lo_s, taus, side="right")  # lo_k <= tau
        n_mid = i_lo - i_hi                                    # interior
        s1 = (self.cum_hi[i_hi] + (self.cum_lo[-1] - self.cum_lo[i_lo])
              + n_mid * taus)
        s2 = (self.cum_hi2[i_hi] + (self.cum_lo2[-1] - self.cum_lo2[i_lo])
              + n_mid * taus * taus)
        return s1, s2

    def objective(self, taus, c1: float, c0: float):
        s1, s2 = self.sums(taus)
        return (c1 * s2 + c0) / np.maximum(s1, 1e-30) ** 2


# dense (grid, K) evaluation below this K, prefix sums from it up (the two
# differ only in float summation order)
PREFIX_K_THRESHOLD = 4096


def solve_waterfill(prob: P2Problem, grid: int = 4096,
                    refine: int = 60, method: str = "auto") -> SolveResult:
    """Exact water-filling P2 solve in numpy f64. ``method``: "dense" (the
    (grid, K) matrix), "prefix" (``_PrefixEvaluator``) or "auto" (by K)."""
    lo, hi = _t_bounds(prob)
    active = prob.b > 0
    if not np.any(active):
        return SolveResult(beta=np.zeros(prob.K), objective=np.inf,
                           lam=0.0, iterations=0, inner="waterfill")
    if method == "auto":
        method = "prefix" if prob.K >= PREFIX_K_THRESHOLD else "dense"
    tau_lo, tau_hi = float(np.min(lo[active])), float(np.max(hi[active]))
    taus = np.linspace(tau_lo, tau_hi, grid)
    if method == "prefix":
        ev = _PrefixEvaluator(lo[active], hi[active])

        def objective(ts_arr):
            return ev.objective(ts_arr, prob.c1, prob.c0)
    else:
        def objective(ts_arr):
            ts = np.clip(ts_arr[:, None], lo[None, :], hi[None, :]) \
                * prob.b[None, :]
            return (prob.c1 * np.sum(ts * ts, 1) + prob.c0) / np.maximum(
                np.sum(ts, 1), 1e-30) ** 2

    # grid scan, then golden-section refine, one loop for both evaluators
    vals = objective(taus)
    vmin = float(np.min(vals))
    j = int(np.argmax(vals <= vmin * (1.0 + WATERFILL_TIE_RTOL)))
    a, bnd = taus[max(j - 1, 0)], taus[min(j + 1, grid - 1)]
    gr = (np.sqrt(5.0) - 1) / 2
    for _ in range(refine):
        m1 = bnd - gr * (bnd - a)
        m2 = a + gr * (bnd - a)
        f1, f2 = objective(np.array([m1, m2]))
        if f1 < f2:
            bnd = m2
        else:
            a = m1
    tau = (a + bnd) / 2
    t = np.clip(tau, lo, hi) * prob.b
    # recover beta from t = pm (theta + (rho - theta) beta)
    d = prob.p_max * (prob.rho - prob.theta)
    base = prob.p_max * prob.theta
    beta = np.where(np.abs(d) > 1e-12, (t - base) / np.where(
        np.abs(d) > 1e-12, d, 1.0), 0.5)
    beta = np.clip(beta, 0.0, 1.0)
    obj = prob.objective(beta)
    return SolveResult(beta=beta, objective=obj,
                       lam=1.0 / max(obj, 1e-30), iterations=1,
                       inner="waterfill")


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
                   grid: int = 4096, refine: int = 60, reducer=None):
    """Returns (beta (K,), objective scalar), both f32 tensors.

    With no active client (b all zero) beta is arbitrary and the objective
    degenerate; the caller's zero-uploader guard makes the round a no-op.

    ``reducer`` (``repro_torch.launch.collectives.Reducer``): the (K,)
    inputs are this rank's rows of a federation sharded over the reducer's
    axes, as the reference's ``axis_name``. The reductions over K are
    packed without changing a value: the bracket's min, max and "any
    active" are one MAX all-reduce of [-lo, hi, any], the grid's sums of t
    and t^2 one (2, grid) sum, each golden-section step's two pairs one
    4-float sum, the objective's pair one more. Every rank then holds the
    same sums, takes the same branches, and returns its slice of the same
    beta. ``reducer=None`` is the single-device program, op for op."""
    if reducer is not None:
        return _waterfill_sharded(rho, theta, p_max, b, c1, c0, grid,
                                  refine, reducer)
    c1, c0 = f32(c1), f32(c0)
    lo, hi, active = _lo_hi(rho, theta, p_max, b)
    any_active = active.any()
    inf = torch.full_like(lo, float("inf"))
    tau_lo = torch.where(any_active, torch.where(active, lo, inf).min(),
                         torch.zeros_like(lo[0]))
    tau_hi = torch.where(any_active, torch.where(active, hi, -inf).max(),
                         torch.ones_like(hi[0]))

    def ratio(t):                       # (..., K) -> (...)
        return _ratio(_ksum(t), _ksum_sq(t), c1, c0)

    return _solve(ratio, tau_lo, tau_hi, lo, hi, rho, theta, p_max, b, grid,
                  refine)


def _lo_hi(rho, theta, p_max, b):
    """The interval [lo_k, hi_k] of t_k = b_k p_k(beta_k), and b > 0."""
    p0 = torch.minimum(torch.clamp_min(p_max * theta, 0.0), p_max)
    p1 = torch.minimum(torch.clamp_min(p_max * rho, 0.0), p_max)
    return torch.minimum(p0, p1) * b, torch.maximum(p0, p1) * b, b > 0


def _ratio(s, q, c1, c0):
    """P2's objective (c1 sum t^2 + c0) / (sum t)^2 from the two sums."""
    return _fma(q, c1, c0) / torch.clamp_min(s * s, f32(1e-30))


def _solve(ratio, tau_lo, tau_hi, lo, hi, rho, theta, p_max, b, grid,
           refine):
    """The grid scan over [tau_lo, tau_hi], the golden-section refine and
    the beta recovery, with ``ratio`` mapping (..., K) t to (...)."""
    taus = _fma(tau_hi - tau_lo, _grid(grid, lo.device), tau_lo)
    vals = ratio(torch.clamp(taus[:, None], lo[None, :], hi[None, :])
                 * b[None, :])
    thresh = vals.min() * f32(1.0 + WATERFILL_TIE_RTOL)
    # argmax returns the FIRST maximal index; it takes no bool tensors
    j = (vals <= thresh).to(torch.uint8).argmax().reshape(1)
    a = taus.index_select(0, torch.clamp_min(j - 1, 0))[0]
    bnd = taus.index_select(0, torch.clamp_max(j + 1, grid - 1))[0]
    # (m1, m2) = (bnd - gr * width, a + gr * width), each rounded once
    gold = torch.stack([torch.full_like(a, -_GOLDEN),
                        torch.full_like(a, _GOLDEN)]).double()
    for _ in range(refine):
        m = _fma(gold, bnd - a, torch.stack([bnd, a]))
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
    mix = _fma(beta, rho, (1.0 - beta) * theta)
    p = torch.minimum(torch.clamp_min(p_max * mix, 0.0), p_max) * b
    return beta, ratio(p)


def _waterfill_sharded(rho, theta, p_max, b, c1, c0, grid, refine,
                       reducer):
    """``waterfill_beta`` over rows sharded across ``reducer``'s ranks."""
    c1, c0 = f32(c1), f32(c0)
    lo, hi, active = _lo_hi(rho, theta, p_max, b)
    inf = torch.full_like(lo, float("inf"))
    ends = torch.stack([-torch.where(active, lo, inf).min(),
                        torch.where(active, hi, -inf).max(),
                        active.any().float()])
    ends = reducer.max(ends, tag="waterfill_bracket")
    any_active = ends[2] > 0
    tau_lo = torch.where(any_active, -ends[0], torch.zeros_like(ends[0]))
    tau_hi = torch.where(any_active, ends[1], torch.ones_like(ends[1]))

    def ratio(t):                       # (..., K_local) -> (...)
        sums = torch.stack([_ksum(t), _ksum_sq(t)])
        tag = "waterfill_grid" if t.dim() == 2 and t.shape[0] > 2 else (
            "waterfill_refine" if t.dim() == 2 else "waterfill_objective")
        sums = reducer.sum(sums, tag=tag)
        return _ratio(sums[0], sums[1], c1, c0)

    return _solve(ratio, tau_lo, tau_hi, lo, hi, rho, theta, p_max, b, grid,
                  refine)


def solve_waterfill_jnp(prob: P2Problem, device=None) -> SolveResult:
    """``waterfill_beta`` on ``device`` (``None`` is the card) behind the
    host solvers' interface (the reference's ``solver="waterfill_jnp"``):
    the f32 solver the fused round runs, so the host path and the fused
    round solve P2 alike."""
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    beta, obj = waterfill_beta(put(prob.rho), put(prob.theta),
                               put(prob.p_max), put(prob.b),
                               float(prob.c1), float(prob.c0))
    obj = float(obj)
    return SolveResult(beta=beta.cpu().numpy().astype(float), objective=obj,
                       lam=1.0 / max(obj, 1e-30), iterations=1,
                       inner="waterfill_jnp")
