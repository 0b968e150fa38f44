"""The paper's synchronous baselines (Section IV-B), torch form.

Port of ``repro.fl.baselines``:

(1) Local SGD [McMahan et al., AISTATS'17], ideal synchronous FedAvg:
    lossless transmission and an exact D_k/D-weighted average; a round lasts
    as long as the slowest selected client (the straggler clock).

(2) COTAF [Sery & Cohen, TSP'20], synchronous AirComp: the clients transmit
    their model updates with the time-varying precoding
    alpha_t = P / max_k ||dw_k||^2, and the server receives their mean plus
    AWGN scaled by 1 / (K sqrt(alpha_t)).

Both train the selected clients on the device (``BatchedEngine``, epoch-
cursor plans) and keep the global model in f64 on the device, as the
reference keeps it in f64 numpy; ``global_params`` hands the model out in
f32. The selection (``np.random.default_rng(seed).choice``) and the
straggler clock (``SemiAsyncScheduler.sync_round_time``, PCG64) are numpy,
bit-equal to the reference's. COTAF's unit-normal noise comes from a draw
source whose ``noise(i)`` gives round i's (d,) f32 draw: by default keyed on
(seed + 77, i) through a ``torch.Generator``; tests replay the reference's
split chain of ``PRNGKey(seed + 77)`` through ``ArrayDraws``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core.aggregation import ravel, tree_map
from repro_torch.core.aircomp import ChannelConfig
from repro_torch.core.scheduler import (TAG_NOISE, SchedulerConfig,
                                        SemiAsyncScheduler,
                                        round_tag_generator)
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.fl.engine import make_engine


@dataclass
class SyncConfig:
    n_select: int = 50           # participants per round (matched to
                                 # PAOTA's mean participation)
    engine: str = "batched"      # local-training engine
    seed: int = 0


class UnitNormalDraws:
    """Round i's (d,) f32 N(0, 1) draw, keyed on (seed, i, TAG_NOISE)."""

    def __init__(self, seed: int, d: int, device):
        self.device = resolve_device(device)
        self.seed, self.d = int(seed), d

    def noise(self, i: int) -> torch.Tensor:
        gen = round_tag_generator(self.seed, i, TAG_NOISE, self.device)
        return torch.randn((self.d,), generator=gen, device=self.device,
                           dtype=torch.float32)


class _SyncServerBase:
    def __init__(self, init_params, clients, sched_cfg: SchedulerConfig,
                 cfg: SyncConfig, *, device=None):
        self.device = resolve_device(device)
        full_f32_matmul()
        self.engine = make_engine(clients, cfg.engine, device=self.device)
        self.cfg = cfg
        self.scheduler = SemiAsyncScheduler(sched_cfg)
        params = tree_map(lambda t: torch.as_tensor(
            t, dtype=torch.float32, device=self.device), init_params)
        vec, self.unravel = ravel(params)
        self.d = int(vec.numel())
        self._global = vec.double()
        self.rng = np.random.default_rng(cfg.seed)
        self.time = 0.0
        self.round_idx = 0
        self.history: List[dict] = []

    @property
    def global_vec(self) -> np.ndarray:
        """The f64 global model as a numpy (d,) vector."""
        return self._global.cpu().numpy()

    def global_params(self):
        """The global model in f32, as a params dict on the device."""
        return self.unravel(self._global.float())

    def _select(self):
        n = min(self.cfg.n_select, self.engine.n_clients)
        return self.rng.choice(self.engine.n_clients, size=n, replace=False)

    def _train_selected(self, sel):
        """The (n, d) f32 trained rows of ``sel`` and their f64 sizes."""
        params = self.unravel(self._global.float())
        outs = self.engine.local_train(params, sel)
        weights = self.engine.n_samples[np.asarray(sel, np.int64)]
        return outs, np.asarray(weights, float)

    def _advance_clock(self, n):
        # synchronous: wait for the slowest selected client
        self.time += self.scheduler.sync_round_time(n)
        self.round_idx += 1

    def round(self) -> dict:
        with torch.no_grad():
            return self._round()


class LocalSGDServer(_SyncServerBase):
    """Ideal synchronous FedAvg (no transmission loss)."""

    def _round(self) -> dict:
        sel = self._select()
        stacked, w = self._train_selected(sel)
        w = torch.as_tensor(w / w.sum(), device=self.device)
        self._global = w @ stacked.double()
        self._advance_clock(len(sel))
        info = {"round": self.round_idx, "time": self.time,
                "n_participants": len(sel)}
        self.history.append(info)
        return info


class COTAFServer(_SyncServerBase):
    """Synchronous AirComp with time-varying precoding."""

    def __init__(self, init_params, clients, sched_cfg, cfg: SyncConfig,
                 chan: ChannelConfig, *, device=None, draws=None):
        super().__init__(init_params, clients, sched_cfg, cfg, device=device)
        self.chan = chan
        if draws is None:
            draws = UnitNormalDraws(cfg.seed + 77, self.d, self.device)
        elif draws.device != self.device:
            raise ValueError(f"draws on {draws.device}, server on "
                             f"{self.device}")
        self.draws = draws

    def _round(self) -> dict:
        sel = self._select()
        stacked, _ = self._train_selected(sel)
        deltas = stacked.double() - self._global[None, :]
        k = len(sel)
        # precoding: scale so the max-energy update meets the power budget
        max_e = max(float((deltas * deltas).sum(1).max()), 1e-12)
        alpha_t = self.chan.p_max_watts / max_e
        scale = self.chan.sigma_n / (k * math.sqrt(alpha_t))
        noise = scale * self.draws.noise(self.round_idx).double()
        self._global = self._global + deltas.mean(0) + noise
        self._advance_clock(k)
        info = {"round": self.round_idx, "time": self.time,
                "n_participants": k, "alpha_t": alpha_t}
        self.history.append(info)
        return info
