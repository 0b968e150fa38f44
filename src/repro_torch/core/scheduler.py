"""Time-triggered semi-asynchronous scheduler (Section II-B), torch form.

Port of ``repro.core.scheduler``: the consumer tags, the exact slot
predicate, the scheduler state transition over (K,) tensors (the fused
round), and ``SemiAsyncScheduler``, the host-side numpy scheduler of the
host-path servers, with both of the reference's rng modes. The reference
keys its draws with JAX's threefry ``round_tag_key``; the port
keys a ``torch.Generator`` on the same (seed, round, tag) triple instead
(``round_tag_generator``). The two give different numbers from one seed,
so parity tests hand the reference's own draws to the port
(``repro_torch.fl.runtime.ArrayDraws``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import f32

# one tag per independent per-round RNG consumer — same values as the
# reference, so a (seed, round, tag) triple names the same stream role
TAG_LATENCY, TAG_CHANNEL, TAG_NOISE, TAG_BATCH = 0, 1, 2, 3
TAG_AVAIL, TAG_DROPOUT, TAG_SCHED, TAG_TRAIT = 4, 5, 6, 7
TAG_COMPRESS, TAG_QUANT = 8, 9
TAG_FAULT = 10

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def round_tag_seed(base_seed: int, round_idx: int, tag: int) -> int:
    """Counter-based per-round seed: mix the round index, then the tag,
    into the base seed (the port's ``fold_in(fold_in(key, r), tag)``)."""
    h = _splitmix64(int(base_seed) & _MASK64)
    h = _splitmix64(h ^ (int(round_idx) & _MASK64))
    h = _splitmix64(h ^ int(tag))
    return h >> 1            # manual_seed takes a non-negative 63-bit int


def round_tag_generator(base_seed: int, round_idx: int, tag: int,
                        device) -> torch.Generator:
    """A fresh generator on ``device`` whose stream is a pure function of
    (seed, round, tag): chunking rounds never changes the draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(round_tag_seed(base_seed, round_idx, tag))
    return gen


def counter_latencies(base_seed: int, round_idx: int, k: int, lo: float,
                      hi: float, device) -> torch.Tensor:
    """All K latency draws for the broadcast of round ``round_idx``:
    U(lo, hi) in f32, keyed on (seed, round) only."""
    gen = round_tag_generator(base_seed, round_idx, TAG_LATENCY, device)
    u = torch.rand((k,), generator=gen, device=device, dtype=torch.float32)
    return f32(lo) + (f32(hi) - f32(lo)) * u


def slot_ready(lat, model_round, round_idx: int, delta_t: float):
    """Exact slot predicate ``lat <= (round_idx + 1 - j) * delta_t``: one
    multiply in ``lat``'s own dtype (the reference's ``slot_ready``; an f64
    or Python-float product flips slot boundaries). Takes (K,) tensors, or
    numpy arrays on the host scheduler."""
    m = (round_idx + 1) - model_round
    if isinstance(lat, np.ndarray):
        return lat <= m.astype(lat.dtype) * lat.dtype.type(delta_t)
    return lat <= m.to(lat.dtype) * f32(delta_t)


def sched_advance(ready, busy_lat, model_round, round_idx: int,
                  delta_t: float):
    """At the slot of round ``round_idx``: flip the ready bits of clients
    whose training finished and compute staleness s_k = round - model_round
    (0 for busy clients). Returns (ready, staleness i32)."""
    ready = ready | slot_ready(busy_lat, model_round, round_idx, delta_t)
    stal = torch.where(ready, round_idx - model_round,
                       torch.zeros_like(model_round))
    return ready, stal


def sched_broadcast(ready, busy_lat, model_round, upl_mask, lat,
                    new_round: int):
    """Clients under ``upl_mask`` receive the new global model, go busy for
    their latency draw, and record the round they train on; a masked no-op
    for everyone else."""
    ready = ready & ~upl_mask
    busy_lat = torch.where(upl_mask, lat, busy_lat)
    model_round = torch.where(upl_mask,
                              torch.full_like(model_round, new_round),
                              model_round)
    return ready, busy_lat, model_round


@dataclass
class SchedulerConfig:
    n_clients: int = 100
    delta_t: float = 8.0
    lat_lo: float = 5.0
    lat_hi: float = 15.0
    seed: int = 0
    rng: str = "host"             # host scheduler only: "host" draws its
                                  # latencies from a sequential PCG64 stream,
                                  # "counter" keys them on (seed, round)


class SemiAsyncScheduler:
    """Host-side periodic aggregation (the reference's array-state
    ``SemiAsyncScheduler``): ready bits, latency draws and model rounds as
    numpy arrays, a finish decided by ``slot_ready``.

    ``rng="host"``: one PCG64 uniform per broadcast client, in id order, kept
    in f64. ``rng="counter"``: all K latencies of broadcast round r come from
    ``latencies(r)`` (default ``counter_latencies`` keyed on (seed, r)) and
    the broadcast clients index them, kept in f32 as the fused round keeps
    them. The synchronous baselines' straggler clock ``sync_round_time``
    draws from the PCG64 stream."""

    def __init__(self, cfg: SchedulerConfig, scenario=None,
                 latencies: Optional[Callable[[int], np.ndarray]] = None):
        if scenario is not None:
            raise NotImplementedError(
                "scenario= selects the reference's client-state simulator, "
                "which the port's host scheduler does not have yet")
        if cfg.rng not in ("host", "counter"):
            raise ValueError(f"rng={cfg.rng!r} (expected 'host' or "
                             f"'counter')")
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.time = 0.0
        self.round = 0
        self.ready = np.ones(cfg.n_clients, dtype=bool)
        lat_dtype = np.float32 if cfg.rng == "counter" else np.float64
        self.busy_lat = np.zeros(cfg.n_clients, dtype=lat_dtype)
        self.model_round = np.zeros(cfg.n_clients, dtype=np.int64)
        if latencies is None:
            def latencies(r):
                return counter_latencies(cfg.seed, r, cfg.n_clients,
                                         cfg.lat_lo, cfg.lat_hi,
                                         "cpu").numpy()
        self._latencies = latencies

    def _draw_latency(self, size=None):
        return self.rng.uniform(self.cfg.lat_lo, self.cfg.lat_hi, size)

    def start_round(self, participant_ids) -> None:
        """Broadcast: the clients in ``participant_ids`` receive w_g^r and
        start training, each with a fresh latency draw."""
        ids = np.asarray(participant_ids, dtype=np.int64)
        if ids.size == 0:
            return
        if self.cfg.rng == "counter":
            lat = np.asarray(self._latencies(self.round),
                             dtype=np.float32)[ids]
        else:
            lat = self._draw_latency(ids.size)
        self.ready[ids] = False
        self.model_round[ids] = self.round
        self.busy_lat[ids] = lat

    def advance_to_aggregation(self) -> Tuple[np.ndarray, np.ndarray]:
        """Advance the clock by delta_t. Returns (uploaders, staleness):
        the ids with b_k = 1 at this slot, and s_k for every client (0 for
        the busy ones)."""
        self.ready |= slot_ready(self.busy_lat, self.model_round, self.round,
                                 self.cfg.delta_t)
        stal = np.where(self.ready, self.round - self.model_round, 0)
        uploaders = np.flatnonzero(self.ready).astype(np.int64)
        self.round += 1
        self.time = self.round * self.cfg.delta_t
        return uploaders, stal.astype(np.int64)

    def sync_round_time(self, n_participants: int) -> float:
        """A synchronous round lasts as long as the slowest of its
        ``n_participants`` latency draws."""
        return float(np.max(self._draw_latency(n_participants)))
