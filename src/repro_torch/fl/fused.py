"""Fused PAOTA server, torch form: R aggregation periods per ``advance``.

Port of ``repro.fl.fused.FusedPAOTA`` on the dense, raveled, f32 path, in
both transmit modes. Every stage of a round runs on the device
(``repro_torch.fl.runtime.paota_round_step``), the two sweeps of the (K, d)
delta plane through the hand-written CUDA kernels on a GPU. The per-round
metrics are copied to the host once per ``advance``, as the reference's
scan outputs are.

Randomness comes from a draw source (``repro_torch.fl.runtime``): by
default ``CounterDraws`` keyed on ``sched_cfg.seed`` (latencies) and
``cfg.seed`` (channel, noise, minibatch plans), the roles the reference's
seeds play; ``draws=ArrayDraws(...)`` replays given draws instead.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.aggregation import ravel, tree_map
from repro_torch.core.aircomp import ChannelConfig
from repro_torch.core.power_control import p2_constants
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.fl.engine import BatchedEngine
from repro_torch.fl.runtime import (DEVICE_METRICS, CounterDraws, RoundCarry,
                                    RoundCfg, RoundStreams, init_round_carry,
                                    scan_rounds)
from repro_torch.fl.server import PAOTAConfig

__all__ = ["FusedPAOTA"]

# The reference's keyword knobs for branches the port has not ported
# (pytree params, bf16 carry, active cohort, scenarios, compressed payloads,
# faults, screening, divergence rollback, checkpoints), each with the value
# that keeps the dense, raveled, f32 path. Any other value is refused.
_NOT_PORTED = {"params_mode": "raveled", "pending_dtype": "float32",
               "cohort_size": None, "scenario": None, "compress": None,
               "compress_ratio": 1.0, "slot_dtype": None,
               "error_feedback": True, "faults": None, "screen": False,
               "screen_max_norm": 0.0, "divergence_factor": 0.0,
               "checkpoint_every": 0, "checkpoint_dir": None}


def _refuse_unported(knobs: dict) -> None:
    for name, value in knobs.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"FusedPAOTA got an unexpected keyword {name!r}")
        keep = _NOT_PORTED[name]
        if value != keep and not (keep is None and not value):
            raise NotImplementedError(
                f"{name}={value!r} selects a branch of the reference round "
                f"that the port does not have yet; the ported path is "
                f"{name}={keep!r}")


class FusedPAOTA:
    """PAOTA server whose rounds run entirely on the device.

    Same constructor shape as the reference's; ``clients`` is a list of
    ``repro_torch.fl.client.FLClient`` or a ``BatchedEngine``. ``device``
    defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, init_params, clients, chan: ChannelConfig,
                 sched_cfg: SchedulerConfig, cfg: PAOTAConfig, *,
                 device=None, draws=None, **not_ported):
        self.device = resolve_device(device)
        full_f32_matmul()
        _refuse_unported(not_ported)
        if cfg.use_kernel:
            raise ValueError("use_kernel routes through the host-path "
                             "server; the fused round is already one fused "
                             "device path")
        if cfg.solver not in ("waterfill", "waterfill_jnp"):
            raise ValueError(f"FusedPAOTA solves P2 by water-filling only; "
                             f"solver={cfg.solver!r} needs the host-path "
                             f"server")
        if cfg.engine != "batched":
            raise NotImplementedError(f"engine={cfg.engine!r}: the port has "
                                      f"the batched engine only")
        if cfg.transmit not in ("model", "delta"):
            raise ValueError(f"transmit={cfg.transmit!r} (expected 'model' "
                             f"or 'delta')")
        if isinstance(clients, BatchedEngine):
            engine = clients
            if engine.device != self.device:
                raise ValueError(f"engine on {engine.device}, FusedPAOTA on "
                                 f"{self.device}")
        else:
            engine = BatchedEngine.from_clients(list(clients),
                                                device=self.device)
        self.engine = engine
        params = tree_map(lambda t: torch.as_tensor(
            t, dtype=torch.float32, device=self.device), init_params)
        self._init_vec, self.unravel = ravel(params)
        self.d = int(self._init_vec.numel())
        self.k = engine.n_clients
        c1, c0 = p2_constants(cfg.smooth_l, cfg.eps_bound, self.k, self.d,
                              chan.sigma_n2)
        self._rcfg = RoundCfg(omega=cfg.omega, c1=c1, c0=c0,
                              p_max_watts=chan.p_max_watts,
                              delta_t=sched_cfg.delta_t,
                              transmit_delta=cfg.transmit == "delta")
        if draws is None:
            draws = CounterDraws(
                sched_cfg.seed, cfg.seed, self.device, k=self.k, d=self.d,
                lat_lo=sched_cfg.lat_lo, lat_hi=sched_cfg.lat_hi, chan=chan,
                n_samples=engine.n_samples, local_steps=engine.local_steps,
                batch_size=engine.batch_size)
        elif draws.device != self.device:
            raise ValueError(f"draws on {draws.device}, FusedPAOTA on "
                             f"{self.device}")
        self.draws = draws
        self._streams = RoundStreams(
            local_train=lambda g, r: engine.train_all(self.unravel(g),
                                                      draws.batch_plan(r)),
            latencies=draws.latencies, channel=draws.channel,
            noise=draws.noise)
        self._carry: RoundCarry | None = None
        self.history: List[dict] = []

    @property
    def global_vec(self):
        """w_g^t as a numpy (d,) vector, in the reference's ravel order."""
        g = self._init_vec if self._carry is None else self._carry.global_vec
        return g.detach().cpu().numpy()

    def global_params(self):
        """w_g^t as a params dict of views on the device."""
        g = self._init_vec if self._carry is None else self._carry.global_vec
        return self.unravel(g)

    def _ensure_carry(self) -> RoundCarry:
        if self._carry is None:
            self._carry = init_round_carry(
                self._init_vec, streams=self._streams,
                keep_pending=not self._rcfg.transmit_delta)
        return self._carry

    def advance(self, n_rounds: int) -> List[dict]:
        """Run ``n_rounds`` rounds; appends and returns the per-round
        history dicts (one device-to-host copy for all of them)."""
        if n_rounds < 1:
            return []
        with torch.no_grad():
            carry = self._ensure_carry()
            self._carry, outs = scan_rounds(carry, n_rounds, rcfg=self._rcfg,
                                            streams=self._streams)
        host = torch.stack([outs[k] for k in DEVICE_METRICS]).cpu().numpy()
        base = len(self.history)
        rows = []
        for i in range(n_rounds):
            row = {"round": base + i, "time": outs["time"][i]}
            row.update({k: float(host[j, i])
                        for j, k in enumerate(DEVICE_METRICS)})
            row["n_participants"] = int(row["n_participants"])
            # screening and rollback are not ported: nothing is screened
            # and nothing rolls back
            row.update(n_screened=0.0, rolled_back=0.0)
            rows.append(row)
        self.history.extend(rows)
        return rows

    def round(self) -> dict:
        """One round (drop-in for the host server's ``round``)."""
        return self.advance(1)[-1]
