"""Beyond-paper ablations of PAOTA's power-control trade-off (eq. 25):

  * solver ablation: exact water-filling vs the paper's Dinkelbach path vs
    fixed beta corners (beta=1 staleness-only, beta=0 similarity-only,
    beta=0.5) — how much the P2 optimization buys in end-task accuracy,
    not just in the bound.
  * partitioner ablation: the paper's shard partition vs Dirichlet(0.3).
  * transmit ablation: model vs delta transmission at N0 = -34 dBm/Hz.

The port's ``benchmarks/ablation.py``; every variant runs the host-path
``PAOTAServer`` on the device."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import common
from repro_torch.core import ChannelConfig, SchedulerConfig
from repro_torch.core.dinkelbach import SolveResult
from repro_torch.data.partition import partition_dirichlet
from repro_torch.data.pipeline import build_federation
from repro_torch.device import resolve_device
from repro_torch.fl import FLClient, PAOTAConfig, PAOTAServer, evaluate
from repro_torch.fl import server as srv_mod
from repro_torch.models.mlp import mlp_apply, mlp_loss

FIXED_BETA = {"beta1_staleness_only": 1.0, "beta0_similarity_only": 0.0,
              "beta05_fixed": 0.5}
SOLVER_VARIANTS = ("waterfill", "pgd") + tuple(FIXED_BETA)


class _FixedBetaServer(PAOTAServer):
    """PAOTA with beta held at one value for every client: each round
    swaps ``repro_torch.fl.server.solve_p2`` for a stand-in and restores
    it in a ``finally`` block, as the reference's does."""

    def __init__(self, *args, beta: float, **kw):
        self._beta = beta
        super().__init__(*args, **kw)

    def round(self):
        orig = srv_mod.solve_p2
        beta = self._beta

        def fixed(prob, method, device=None):
            b = np.full(prob.K, beta)
            return SolveResult(beta=b, objective=prob.objective(b),
                               lam=0.0, iterations=0, inner=f"fixed{beta}")

        srv_mod.solve_p2 = fixed
        try:
            return super().round()
        finally:
            srv_mod.solve_p2 = orig


def _accuracy_row(name, srv, s, x_te, y_te):
    t0 = time.time()
    for _ in range(s.n_rounds):
        srv.round()
    acc = evaluate(srv.global_params(), x_te, y_te, mlp_apply)["accuracy"]
    return {"name": f"ablation_{name}",
            "us_per_call": round((time.time() - t0) * 1e6 / s.n_rounds, 1),
            "derived": f"acc@{s.n_rounds}rounds={acc:.4f}"}


def run_solver_ablation(device=None, names=SOLVER_VARIANTS,
                        world=None) -> list:
    """The solver variants ``names`` at N0 = -74 dBm/Hz, the noisy regime
    where power control matters. ``world`` is ``(setting, clients, params,
    data)`` to reuse one federation."""
    dev = resolve_device(device)
    if world is None:
        s = common.BenchSetting.from_env(n_rounds=30)
        world = (s,) + common.build_world(s)
    s, clients, params, (_, _, x_te, y_te) = world
    chan = ChannelConfig(n0_dbm_hz=-74.0)
    rows = []
    for name in names:
        sched = SchedulerConfig(n_clients=s.n_clients, seed=s.seed)
        if name in FIXED_BETA:
            srv = _FixedBetaServer(params, clients, chan, sched,
                                   PAOTAConfig(), beta=FIXED_BETA[name],
                                   device=dev)
        else:
            srv = PAOTAServer(params, clients, chan, sched,
                              PAOTAConfig(solver=name), device=dev)
        rows.append(_accuracy_row(name, srv, s, x_te, y_te))
    return rows


def run_partition_ablation(device=None, world=None) -> list:
    """Water-filling PAOTA on a Dirichlet(0.3) partition of the same
    training set."""
    dev = resolve_device(device)
    if world is None:
        s = common.BenchSetting.from_env(n_rounds=30)
        world = (s,) + common.build_world(s)
    s, _, params, (x_tr, y_tr, x_te, y_te) = world
    parts = partition_dirichlet(y_tr, n_clients=s.n_clients, alpha=0.3,
                                seed=s.seed)
    fed = build_federation(x_tr, y_tr, parts, seed=s.seed)
    dcl = [FLClient(d, mlp_loss, batch_size=s.batch_size, lr=s.lr,
                    local_steps=s.local_steps) for d in fed]
    srv = PAOTAServer(params, dcl, ChannelConfig(n0_dbm_hz=-74.0),
                      SchedulerConfig(n_clients=s.n_clients, seed=s.seed),
                      PAOTAConfig(solver="waterfill"), device=dev)
    return [_accuracy_row("dirichlet_partition", srv, s, x_te, y_te)]


def run_transmit_ablation(device=None) -> list:
    """Model- vs delta-transmission under a channel harsh enough to break
    the paper's full-model uplink."""
    dev = resolve_device(device)
    rows = []
    s = common.BenchSetting.from_env(n_rounds=25)
    clients, params, data = common.build_world(s)
    _, _, x_te, y_te = data
    chan = ChannelConfig(n0_dbm_hz=-34.0)
    for mode in ("model", "delta"):
        srv = PAOTAServer(params, clients, chan,
                          SchedulerConfig(n_clients=s.n_clients, seed=s.seed),
                          PAOTAConfig(solver="waterfill", transmit=mode),
                          device=dev)
        rows.append(_accuracy_row(f"transmit_{mode}_n0-34", srv, s, x_te,
                                  y_te))
    return rows


def run(device=None) -> list:
    s = common.BenchSetting.from_env(n_rounds=30)
    world = (s,) + common.build_world(s)
    return (run_solver_ablation(device, world=world)
            + run_partition_ablation(device, world=world)
            + run_transmit_ablation(device))


if __name__ == "__main__":
    for row in run():
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
