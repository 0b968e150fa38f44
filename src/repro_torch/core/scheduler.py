"""Time-triggered semi-asynchronous scheduler (Section II-B), torch form.

Port of ``repro.core.scheduler``: the consumer tags, the exact slot
predicate and the scheduler state transition over (K,) tensors. The
reference keys its draws with JAX's threefry ``round_tag_key``; the port
keys a ``torch.Generator`` on the same (seed, round, tag) triple instead
(``round_tag_generator``). The two give different numbers from one seed,
so parity tests hand the reference's own draws to the port
(``repro_torch.fl.runtime.ArrayDraws``).
"""
from __future__ import annotations

from dataclasses import dataclass

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


def slot_ready(lat: torch.Tensor, model_round: torch.Tensor, round_idx: int,
               delta_t: float) -> torch.Tensor:
    """Exact slot predicate ``lat <= (round_idx + 1 - j) * delta_t``: one
    multiply in ``lat``'s own dtype (the reference's ``slot_ready``; an f64
    or Python-float product flips slot boundaries)."""
    m = (round_idx + 1) - model_round
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
