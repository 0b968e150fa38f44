"""PAOTA server — Algorithm 1 on the host path, torch form.

Port of ``repro.fl.server``. Per aggregation period (every delta_t seconds
of simulated time) ``PAOTAServer.round``:

  1. collects the uploads of the clients whose local training finished
     (b_k = 1), with their staleness s_k (``SemiAsyncScheduler``, numpy);
  2. computes the eq.-25 factors rho_k and theta_k from the (K, d) delta
     plane on the device (``runtime.eq25_factors``: the ``round_stats``
     kernel on a GPU);
  3. solves P2 for beta on the host (``core.dinkelbach.solve_p2``: numpy
     water-filling, PGD, MILP or exhaustive, or the fused round's f32
     water-filling) and sets p_k = p_max (beta_k rho_k + (1-beta_k)
     theta_k), capped by the power constraint (7);
  4. AirComp-aggregates the stacked payload with AWGN (eqs. 6 + 8): the
     sweep-2 ``superpose_normalize`` kernel, or with ``use_kernel`` the
     ``aircomp_sum`` kernel;
  5. broadcasts w_g^{r+1} to the uploaders, who restart local training.

A period in which no client finished is a no-op: the global model and its
previous direction are held, and the history records varsigma = 0.

The (K, d) pending models and their starting globals live on the device;
only the (K,) factors cross to the host for P2, and the powers go back as
f32. Randomness: ``PAOTAConfig.rng = "counter"`` (with
``SchedulerConfig(rng="counter")``) takes every draw from a draw source
keyed on the round, ``CounterDraws`` by default, which is what the fused
round (``repro_torch.fl.fused.FusedPAOTA``) consumes. ``rng = "host"``
keeps the reference's host streams: PCG64 latencies and epoch-cursor
minibatch plans in numpy, and channel and noise from the draw source
indexed by the count of aggregating rounds (the order of the reference's
sequential key splits; ``CounterDraws`` keys them on (seed, i, tag) on the
card, and tests replay the reference's split chain through
``ArrayDraws``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core.aggregation import (guarded_global_update,
                                          paota_aggregate_stacked, ravel,
                                          tree_map)
from repro_torch.core.aircomp import VARSIGMA_MIN, ChannelConfig
from repro_torch.core.dinkelbach import SOLVERS, solve_p2
from repro_torch.core.power_control import build_p2
from repro_torch.core.scheduler import SchedulerConfig, SemiAsyncScheduler
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.fl.engine import make_engine
from repro_torch.fl.runtime import (CounterDraws, constraint7_powers,
                                    eq25_factors)


@dataclass
class PAOTAConfig:
    omega: float = 3.0            # staleness constant Omega (Sec. IV-A)
    solver: str = "waterfill"     # P2 solver: waterfill | waterfill_jnp |
                                  # pgd | milp | exhaustive (the fused round
                                  # water-fills in f32: waterfill_jnp)
    smooth_l: float = 10.0        # L (Sec. IV-A)
    eps_bound: float = 0.05       # epsilon (Assumption 3)
    use_kernel: bool = False      # host path: aggregate through the
                                  # aircomp_sum kernel
    engine: str = "batched"       # local-training engine
    transmit: str = "model"       # "model" (eq. 6: clients transmit w_k) |
                                  # "delta" (clients transmit dw_k)
    rng: str = "host"             # host path: "host" (sequential streams)
                                  # | "counter" (draws keyed on the round)
    seed: int = 0


class PAOTAServer:
    """Host-path PAOTA server. ``clients`` is a list of
    ``repro_torch.fl.client.FLClient`` or a ``BatchedEngine``. ``device``
    defaults to ``"cuda"`` and raises without a GPU; ``draws`` replaces the
    default ``CounterDraws`` (see the module docstring)."""

    def __init__(self, init_params, clients, chan: ChannelConfig,
                 sched_cfg: SchedulerConfig, cfg: PAOTAConfig, *,
                 device=None, draws=None):
        self.device = resolve_device(device)
        full_f32_matmul()
        if cfg.solver not in SOLVERS:
            raise ValueError(f"unknown P2 solver {cfg.solver!r} (expected "
                             f"one of {SOLVERS})")
        if cfg.transmit not in ("model", "delta"):
            raise ValueError(f"transmit={cfg.transmit!r} (expected 'model' "
                             f"or 'delta')")
        if cfg.rng not in ("host", "counter"):
            raise ValueError(f"rng={cfg.rng!r} (expected 'host' or "
                             f"'counter')")
        if cfg.rng == "counter" and sched_cfg.rng != "counter":
            raise ValueError("rng='counter' needs SchedulerConfig("
                             "rng='counter') so latency draws match")
        self.engine = make_engine(clients, cfg.engine, device=self.device)
        if self.engine.device != self.device:
            raise ValueError(f"engine on {self.engine.device}, server on "
                             f"{self.device}")
        self.chan = chan
        self.cfg = cfg
        params = tree_map(lambda t: torch.as_tensor(
            t, dtype=torch.float32, device=self.device), init_params)
        vec, self.unravel = ravel(params)
        self._global = vec
        self._prev = vec
        self.d = int(vec.numel())
        k = self.engine.n_clients
        if draws is None:
            draws = CounterDraws(
                sched_cfg.seed, cfg.seed, self.device, k=k, d=self.d,
                lat_lo=sched_cfg.lat_lo, lat_hi=sched_cfg.lat_hi, chan=chan,
                n_samples=self.engine.n_samples,
                local_steps=self.engine.local_steps,
                batch_size=self.engine.batch_size)
        elif draws.device != self.device:
            raise ValueError(f"draws on {draws.device}, server on "
                             f"{self.device}")
        self.draws = draws
        latencies = None
        if cfg.rng == "counter":
            self.engine.enable_counter_plan(draws.batch_plan)

            def latencies(r):
                return draws.latencies(r).cpu().numpy()
        self.scheduler = SemiAsyncScheduler(sched_cfg, latencies=latencies)
        self._n_aggregations = 0      # host mode: index of the next draws
        # in-flight local results: trained model + the global it started from
        self._pending_models = vec.expand(k, -1).clone()
        self._pending_starts = vec.expand(k, -1).clone()
        self.history: List[dict] = []
        with torch.no_grad():
            self._kick_off(np.arange(k))

    @property
    def global_vec(self) -> np.ndarray:
        """w_g^t as a numpy (d,) vector, in the reference's ravel order."""
        return self._global.detach().cpu().numpy()

    @property
    def prev_global(self) -> np.ndarray:
        """w_g^{t-1} as a numpy (d,) vector."""
        return self._prev.detach().cpu().numpy()

    def global_params(self):
        """w_g^t as a params dict of views on the device."""
        return self.unravel(self._global)

    def _kick_off(self, ids) -> None:
        """Broadcast the current global to ``ids`` and train them now (the
        result is consumed when their latency ends). The engine trains all
        K rows; the rows outside ``ids`` are masked out."""
        ids = np.asarray(ids, dtype=np.int64)
        start = self._global
        broadcast_round = self.scheduler.round   # the round `ids` train on
        self.scheduler.start_round(ids)
        if ids.size == 0:
            return
        flat = self.engine.local_train_full(self.unravel(start), ids,
                                            round_idx=broadcast_round)
        m = np.zeros(self.engine.n_clients, bool)
        m[ids] = True
        sel = torch.as_tensor(m, device=self.device)[:, None]
        self._pending_models = torch.where(sel, flat, self._pending_models)
        self._pending_starts = torch.where(sel, start[None, :],
                                           self._pending_starts)

    def round(self) -> dict:
        with torch.no_grad():
            return self._round()

    def _round(self) -> dict:
        upl, stal = self.scheduler.advance_to_aggregation()
        r = self.scheduler.round - 1          # this aggregation's index
        k = self.engine.n_clients
        b = np.zeros(k)
        b[upl] = 1.0
        if b.sum() == 0:
            # nobody finished: nothing superposes, so hold the global and
            # skip P2, channel and AirComp (the draws are not consumed)
            info = {"round": r, "time": self.scheduler.time,
                    "n_participants": 0, "mean_staleness": 0.0,
                    "beta_mean": 0.0, "varsigma": 0.0,
                    "p2_objective": float("inf")}
            self.history.append(info)
            return info

        dev = self.device
        stacked = self._pending_models
        deltas, rho, theta = eq25_factors(
            stacked, self._pending_starts, self._global, self._prev,
            torch.as_tensor(stal, dtype=torch.float32, device=dev),
            self.cfg.omega)
        rho = rho.cpu().numpy().astype(float)
        theta = theta.cpu().numpy().astype(float)

        # P2 -> beta -> powers, on the host
        p_max = np.full(k, self.chan.p_max_watts)
        prob = build_p2(rho, theta, p_max, b, smooth_l=self.cfg.smooth_l,
                        eps_bound=self.cfg.eps_bound, model_dim=self.d,
                        sigma_n2=self.chan.sigma_n2)
        res = solve_p2(prob, self.cfg.solver, device=dev)
        powers = prob.power(res.beta)

        payload = deltas if self.cfg.transmit == "delta" else stacked
        i = r if self.cfg.rng == "counter" else self._n_aggregations
        self._n_aggregations += 1
        h = self.draws.channel(i)
        noise = self.draws.noise(i)
        b_dev = torch.as_tensor(b, dtype=torch.float32, device=dev)
        powers = constraint7_powers(
            torch.as_tensor(powers, dtype=torch.float32, device=dev), h,
            self.chan.p_max_watts, payload=payload)
        agg, varsigma = paota_aggregate_stacked(
            payload, powers, b_dev, noise, use_kernel=self.cfg.use_kernel)
        self._global, self._prev = guarded_global_update(
            self._global, self._prev, agg, varsigma,
            delta=self.cfg.transmit == "delta")

        # uploaders receive the new model and restart (Fig. 2 workflow)
        self._kick_off(upl)

        varsigma = float(varsigma)
        info = {"round": r, "time": self.scheduler.time,
                "n_participants": int(b.sum()),
                "mean_staleness": float(stal[upl].mean()),
                "beta_mean": float(np.mean(res.beta[b > 0])),
                "varsigma": varsigma if varsigma > VARSIGMA_MIN else 0.0,
                "p2_objective": res.objective}
        self.history.append(info)
        return info
