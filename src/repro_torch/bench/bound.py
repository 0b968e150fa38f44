"""Theorem-1 bound benchmark: checks A^r < 1 for the run's hyperparameters
and reports the controllable gap terms (d)+(e) before/after power control —
the quantity PAOTA's P2 optimization minimizes each round.

The port's ``benchmarks/bound.py``: numpy in float64 through the port's
``build_p2`` / ``solve_p2``; nothing runs on the device."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import (BoundConstants, ChannelConfig, build_p2,
                              contraction_A, gap_G, solve_p2)


def run(device=None) -> list:
    """The bound rows; ``device`` is accepted for ``bench.run``'s sake and
    unused (the bound is host arithmetic)."""
    rows = []
    # contraction regime: with L=10, M=5 (Sec. IV-A) the recursion contracts
    # for small enough eta/delta/vartheta — the `A(t) < 1` check the paper
    # requires below Theorem 1
    consts = BoundConstants(eta=0.002, local_steps=5, smooth_l=10.0,
                            delta=0.001, vartheta=0.5)
    a = contraction_A(consts)
    rows.append({"name": "bound_contraction_A", "us_per_call": 0,
                 "derived": f"A={a:.4f};contracts={a < 1}"})
    assert a < 1

    rng = np.random.default_rng(0)
    chan = ChannelConfig()
    k = 100
    rho = 3.0 / (rng.integers(0, 4, k) + 3.0)
    theta = rng.uniform(0.0, 1.0, k)
    b = (rng.random(k) < 0.6).astype(float)
    prob = build_p2(rho, theta, np.full(k, chan.p_max_watts), b,
                    smooth_l=10.0, eps_bound=0.05, model_dim=8070,
                    sigma_n2=chan.sigma_n2)
    t0 = time.time()
    res = solve_p2(prob, "waterfill")
    dt = (time.time() - t0) * 1e6

    # beta = 1 (pure staleness) and beta = 0.5 against the optimum
    naive = prob.objective(np.ones(k))
    uniform = prob.objective(np.full(k, 0.5))
    rows.append({"name": "bound_p2_waterfill_K100",
                 "us_per_call": round(dt, 1),
                 "derived": f"obj={res.objective:.6g};naive={naive:.6g};"
                            f"uniform={uniform:.6g};"
                            f"improvement={(uniform - res.objective) / uniform:.2%}"})

    alphas = prob.power(res.beta) * b
    alphas = alphas / max(alphas.sum(), 1e-12)
    g = gap_G(consts, alphas, float((prob.power(res.beta) * b).sum()),
              model_dim=8070, sigma_n2=chan.sigma_n2)
    rows.append({"name": "bound_gap_terms", "us_per_call": 0,
                 "derived": f"d={g['d']:.4g};e={g['e']:.4g};"
                            f"total={g['total']:.4g}"})
    return rows


if __name__ == "__main__":
    for row in run():
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
