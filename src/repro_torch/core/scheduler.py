"""Time-triggered semi-asynchronous scheduler (Section II-B), torch form.

Port of ``repro.core.scheduler``: the consumer tags, the exact slot
predicate, the scheduler state transition over (K,) tensors (the fused
round), the client-state scenario simulator (``ScenarioConfig``: its
masks, static traits and lognormal latencies as pure functions of their
draws, and the counter draws that feed them), fault injection
(``FaultConfig``: payload and channel fault masks from their (K,)
uniforms, ``inject_payload_faults``), and ``SemiAsyncScheduler``,
the host-side numpy scheduler of the host-path servers, with both of the
reference's rng modes and the scenario. The reference
keys its draws with JAX's threefry ``round_tag_key``; the port
keys a ``torch.Generator`` on the same (seed, round, tag) triple instead
(``round_tag_generator``). The two give different numbers from one seed,
so parity tests hand the reference's own draws to the port
(``repro_torch.fl.runtime.ArrayDraws``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

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


def round_tag_seed(base_seed: int, round_idx: int, tag: int,
                   fold: Optional[int] = None) -> int:
    """Counter-based per-round seed: mix the round index, then the tag
    (then ``fold``, a sub-stream of one tag), into the base seed (the
    port's ``fold_in(fold_in(key, r), tag)``)."""
    h = _splitmix64(int(base_seed) & _MASK64)
    h = _splitmix64(h ^ (int(round_idx) & _MASK64))
    h = _splitmix64(h ^ int(tag))
    if fold is not None:
        h = _splitmix64(h ^ int(fold))
    return h >> 1            # manual_seed takes a non-negative 63-bit int


def round_tag_generator(base_seed: int, round_idx: int, tag: int,
                        device, fold: Optional[int] = None
                        ) -> torch.Generator:
    """A fresh generator on ``device`` whose stream is a pure function of
    (seed, round, tag, fold): chunking rounds never changes the draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(round_tag_seed(base_seed, round_idx, tag, fold))
    return gen


def counter_latencies(base_seed: int, round_idx: int, k: int, lo: float,
                      hi: float, device) -> torch.Tensor:
    """All K latency draws for the broadcast of round ``round_idx``:
    U(lo, hi) in f32, keyed on (seed, round) only."""
    gen = round_tag_generator(base_seed, round_idx, TAG_LATENCY, device)
    u = torch.rand((k,), generator=gen, device=device, dtype=torch.float32)
    return f32(lo) + (f32(hi) - f32(lo)) * u


def counter_uniform(base_seed: int, round_idx: int, tag: int, shape,
                    device, fold: Optional[int] = None) -> torch.Tensor:
    """U[0, 1) f32 draws of ``shape`` keyed on (seed, round, tag, fold)."""
    gen = round_tag_generator(base_seed, round_idx, tag, device, fold)
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


# ---------------------------------------------------------------------------
# client-state scenario simulator (vectorized over the (K,) state plane)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScenarioConfig:
    """Composable client-state scenario (the reference's ``ScenarioConfig``,
    same fields and validation): availability cycles, connectivity
    dropouts, lognormal responsiveness and per-client local-step / batch
    heterogeneity. The default is the identity scenario, bit-identical to
    running with none."""
    availability: str = "always"   # "always" | "cycle" | "bernoulli"
    avail_period: int = 10         # cycle length in rounds ("cycle")
    avail_duty: float = 0.5        # available fraction of the cycle
    avail_prob: float = 0.9        # P(available) ("bernoulli")
    dropout_prob: float = 0.0      # P(a ready upload is lost in transit)
    responsiveness: str = "uniform"  # "uniform" | "lognormal"
    lat_shift: float = 0.0         # lognormal location shift (seconds)
    lat_sigma: float = 0.25        # lognormal per-draw sigma
    lat_mu_spread: float = 0.5     # stddev of the static per-client mu_k
    het_steps: tuple = ()          # per-client local-step choices
    het_batch: tuple = ()          # per-client batch-size choices

    def __post_init__(self):
        if self.availability not in ("always", "cycle", "bernoulli"):
            raise ValueError(f"availability={self.availability!r} (expected "
                             "'always', 'cycle' or 'bernoulli')")
        if self.responsiveness not in ("uniform", "lognormal"):
            raise ValueError(f"responsiveness={self.responsiveness!r} "
                             "(expected 'uniform' or 'lognormal')")
        if self.availability == "cycle" and self.avail_period < 1:
            raise ValueError(f"avail_period={self.avail_period} (expected "
                             ">= 1)")
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError(f"dropout_prob={self.dropout_prob} (expected "
                             "[0, 1))")

    @property
    def has_masks(self) -> bool:
        """True when the scenario can mask uploads at all; the round skips
        the mask stage otherwise."""
        return self.availability != "always" or self.dropout_prob > 0.0


class ScenarioTraits(NamedTuple):
    """Static per-client traits, drawn once (the reference draws them at
    round 0 under ``TAG_TRAIT``): cycle phase, responsiveness offset mu_k,
    local-step count and batch size (None where the scenario leaves the
    dimension alone)."""
    phase: Optional[torch.Tensor]    # (K,) i32
    mu: Optional[torch.Tensor]       # (K,) f32
    steps_k: Optional[torch.Tensor]  # (K,) i32
    batch_k: Optional[torch.Tensor]  # (K,) i32


def scenario_traits(sc: ScenarioConfig, phase=None, z=None,
                    steps_pick=None, batch_pick=None) -> ScenarioTraits:
    """The static traits from their draws: ``phase`` the (K,) cycle phases
    as drawn, ``z`` (K,) standard normals (mu = lat_mu_spread * z), and
    ``steps_pick`` / ``batch_pick`` (K,) indices into the scenario's choice
    tuples. A trait the scenario does not use comes back None."""
    def choice(pick, options):
        return torch.as_tensor(options, dtype=torch.int32,
                               device=pick.device)[pick.long()]

    return ScenarioTraits(
        phase.to(torch.int32) if sc.availability == "cycle" else None,
        (f32(sc.lat_mu_spread) * z if sc.responsiveness == "lognormal"
         else None),
        choice(steps_pick, sc.het_steps) if sc.het_steps else None,
        choice(batch_pick, sc.het_batch) if sc.het_batch else None)


def counter_traits(base_seed: int, k: int, sc: ScenarioConfig,
                   device) -> ScenarioTraits:
    """``scenario_traits`` on draws keyed on (seed, 0, TAG_TRAIT, fold) with
    the reference's folds: 0 phase, 1 mu, 2 step choice, 3 batch choice."""
    def gen(fold):
        return round_tag_generator(base_seed, 0, TAG_TRAIT, device, fold)

    def pick(fold, n):
        return torch.randint(0, max(n, 1), (k,), generator=gen(fold),
                             device=device)

    z = torch.randn((k,), generator=gen(1), device=device,
                    dtype=torch.float32)
    return scenario_traits(sc, pick(0, sc.avail_period), z,
                           pick(2, len(sc.het_steps)),
                           pick(3, len(sc.het_batch)))


def scenario_masks(sc: ScenarioConfig, round_idx: int, k: int, phase=None,
                   u_avail=None, u_drop=None, device=None):
    """(available, dropped) (K,) bool masks at the slot of ``round_idx``,
    a pure function of the static ``phase`` trait ("cycle") and the
    round's (K,) uniforms (``u_avail`` for "bernoulli", ``u_drop`` when
    ``dropout_prob > 0``). An unavailable-but-ready client holds its
    update; a dropped upload is lost and the client restarts."""
    if sc.availability == "always":
        avail = torch.ones((k,), dtype=torch.bool, device=device)
    elif sc.availability == "cycle":
        on_rounds = int(round(sc.avail_duty * sc.avail_period))
        pos = torch.remainder(phase + int(round_idx), sc.avail_period)
        avail = pos < on_rounds
    else:
        avail = u_avail < f32(sc.avail_prob)
    if sc.dropout_prob > 0.0:
        drop = u_drop < f32(sc.dropout_prob)
    else:
        drop = torch.zeros((k,), dtype=torch.bool, device=avail.device)
    return avail, drop


def lognormal_latencies(sc: ScenarioConfig, u, mu, lo: float, hi: float):
    """"lognormal" responsiveness from the round's (K,) uniforms ``u`` and
    the static ``mu`` trait: shift + exp(mu_k + log(med) + sigma *
    ndtri(u_k)), the median session at the midpoint of (lo, hi). Keeps the
    reference's clip of u to [1e-7, 1 - 1e-7] and its f32 log(med)."""
    med = max(0.5 * (lo + hi) - sc.lat_shift, 1e-3)
    z = torch.special.ndtri(torch.clamp(u, f32(1e-7), f32(1.0 - 1e-7)))
    lat = f32(sc.lat_shift) + torch.exp(mu + f32(np.log(med))
                                        + f32(sc.lat_sigma) * z)
    return lat.float()


def counter_scenario_latencies(base_seed: int, round_idx: int, k: int,
                               lo: float, hi: float, sc: ScenarioConfig,
                               mu, device) -> torch.Tensor:
    """Latency draws of broadcast round ``round_idx`` under ``sc``:
    "uniform" is ``counter_latencies`` itself; "lognormal" warps the same
    per-round uniform draw (``lognormal_latencies``)."""
    if sc.responsiveness == "uniform":
        return counter_latencies(base_seed, round_idx, k, lo, hi, device)
    u = counter_uniform(base_seed, round_idx, TAG_LATENCY, (k,), device)
    return lognormal_latencies(sc, u, mu, lo, hi)


def counter_scenario_masks(base_seed: int, round_idx: int, k: int,
                           sc: ScenarioConfig, phase, device):
    """``scenario_masks`` on the (seed, round, TAG_AVAIL / TAG_DROPOUT)
    uniforms."""
    u_avail = u_drop = None
    if sc.availability == "bernoulli":
        u_avail = counter_uniform(base_seed, round_idx, TAG_AVAIL, (k,),
                                  device)
    if sc.dropout_prob > 0.0:
        u_drop = counter_uniform(base_seed, round_idx, TAG_DROPOUT, (k,),
                                 device)
    return scenario_masks(sc, round_idx, k, phase, u_avail, u_drop,
                          device=device)


# ---------------------------------------------------------------------------
# fault injection (the scenario simulator's counter-draw family, TAG_FAULT)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultConfig:
    """Injectable client, channel and pod faults (the reference's
    ``FaultConfig``, same fields and validation). The default is the
    identity: no faults, and the round skips every fault stage.

    Payload faults corrupt a client's trained model the round it restarts,
    from one uniform per client and round split into disjoint bands:
    ``nan_frac`` overwrites the row with NaN (``nan_mode="nan"``) or +Inf
    (``"inf"``); ``byzantine_frac`` scales its delta from the global,
    w' = w_g + byzantine_scale * (w - w_g). ``deep_fade_frac`` scales a
    client's channel draw by ``deep_fade_gain``. ``pod_blackout`` darkens
    whole pods for rounds [blackout_start, blackout_stop): it runs on the
    grouped sharded driver (``repro_torch.fl.ShardedPAOTA`` with
    ``group_period >= 1``), where it joins the availability mask.
    ``start`` / ``stop`` gate the payload and channel faults to rounds in
    [start, stop) (stop = -1: no upper bound)."""
    nan_frac: float = 0.0
    nan_mode: str = "nan"          # "nan" | "inf"
    byzantine_frac: float = 0.0
    byzantine_scale: float = -50.0
    deep_fade_frac: float = 0.0
    deep_fade_gain: float = 1e-4
    pod_blackout: tuple = ()       # pod indices (grouped sharded mode)
    blackout_start: int = 0
    blackout_stop: int = 0         # blackout rounds: [start, stop)
    start: int = 0
    stop: int = -1

    def __post_init__(self):
        if self.nan_mode not in ("nan", "inf"):
            raise ValueError(f"nan_mode={self.nan_mode!r} (expected 'nan' "
                             "or 'inf')")
        for name in ("nan_frac", "byzantine_frac", "deep_fade_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} (expected [0, 1])")
        if self.nan_frac + self.byzantine_frac > 1.0:
            raise ValueError(
                f"nan_frac + byzantine_frac = "
                f"{self.nan_frac + self.byzantine_frac} > 1 (the payload "
                "bands partition one uniform draw)")
        if any(int(p) < 0 for p in self.pod_blackout):
            raise ValueError(f"pod_blackout={self.pod_blackout} (expected "
                             "non-negative pod indices)")

    @property
    def has_payload_faults(self) -> bool:
        return self.nan_frac > 0.0 or self.byzantine_frac > 0.0

    @property
    def has_channel_faults(self) -> bool:
        return self.deep_fade_frac > 0.0

    @property
    def has_blackout(self) -> bool:
        return (len(self.pod_blackout) > 0
                and self.blackout_stop > self.blackout_start)

    @property
    def any(self) -> bool:
        return (self.has_payload_faults or self.has_channel_faults
                or self.has_blackout)


def fault_active(fc: FaultConfig, round_idx: int) -> bool:
    """Payload and channel faults are live at ``round_idx``."""
    t = int(round_idx)
    return t >= fc.start and (fc.stop < 0 or t < fc.stop)


def fault_payload_masks(u, round_idx: int, fc: FaultConfig):
    """(nan_mask, byzantine_mask) (K,) bool from the round's (K,) uniforms
    ``u`` (keyed on (seed, round, TAG_FAULT)): the disjoint bands
    [0, nan_frac) and [nan_frac, nan_frac + byzantine_frac)."""
    if not fault_active(fc, round_idx):
        off = torch.zeros_like(u, dtype=torch.bool)
        return off, off
    nan_m = u < f32(fc.nan_frac)
    byz_m = (u >= f32(fc.nan_frac)) & (
        u < f32(fc.nan_frac + fc.byzantine_frac))
    return nan_m, byz_m


def fault_channel_mask(u, round_idx: int, fc: FaultConfig):
    """Deep-fade (K,) bool mask from the round's fade uniforms ``u`` (a
    sub-stream of the round's TAG_FAULT key, fold 1, so it never
    correlates with the payload bands)."""
    if not fault_active(fc, round_idx):
        return torch.zeros_like(u, dtype=torch.bool)
    return u < f32(fc.deep_fade_frac)


def blackout_active(fc: FaultConfig, round_idx: int) -> bool:
    """The pod-blackout window covers ``round_idx``."""
    return fc.blackout_start <= int(round_idx) < fc.blackout_stop


def inject_payload_faults(trained, global_tree, nan_mask, byz_mask,
                          fc: FaultConfig):
    """Corrupt the faulty rows of freshly trained rows ((rows, ...) leaves
    of a params dict, or a raveled (rows, d) plane) against the matching
    unstacked ``global_tree``: a NaN-faulted row becomes NaN (or +Inf) in
    every leaf; a Byzantine row's delta from the global is scaled by
    ``byzantine_scale``. Masks are (rows,) bool."""
    if isinstance(trained, dict):
        return {key: inject_payload_faults(trained[key], global_tree[key],
                                           nan_mask, byz_mask, fc)
                for key in trained}
    fill = float("nan") if fc.nan_mode == "nan" else float("inf")
    shape = (trained.shape[0],) + (1,) * (trained.dim() - 1)
    gb = global_tree[None].to(trained.dtype)
    out = torch.where(byz_mask.reshape(shape),
                      (gb + f32(fc.byzantine_scale) * (trained - gb)
                       ).to(trained.dtype), trained)
    return torch.where(nan_mask.reshape(shape),
                       torch.full((), fill, dtype=trained.dtype,
                                  device=trained.device), out)


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
    ``latencies(r)`` and the broadcast clients index them, kept in f32 as the
    fused round keeps them. The synchronous baselines' straggler clock
    ``sync_round_time`` draws from the PCG64 stream.

    ``scenario`` (a ``ScenarioConfig``, counter rng only) runs the client-
    state simulator the fused round runs: ``masks(t)`` gives the (K,)
    (available, dropped) masks of slot t and gates who uploads, and the
    default latencies follow the scenario's responsiveness model. After
    ``advance_to_aggregation``, ``restart_ids`` are the clients to
    broadcast to (ready and available: a dropped uploader restarts too);
    without a scenario they are the uploaders. ``latencies`` and ``masks``
    default to the port's counter draws keyed on ``cfg.seed``; tests pass
    the reference's."""

    def __init__(self, cfg: SchedulerConfig, scenario=None,
                 latencies: Optional[Callable[[int], np.ndarray]] = None,
                 masks: Optional[Callable[[int], tuple]] = None):
        if cfg.rng not in ("host", "counter"):
            raise ValueError(f"rng={cfg.rng!r} (expected 'host' or "
                             f"'counter')")
        if scenario is not None and cfg.rng != "counter":
            raise ValueError("scenario simulation needs counter RNG "
                             "(SchedulerConfig(rng='counter')): the per-round "
                             "masks are keyed draws shared with the fused "
                             "scan, which a sequential PCG64 stream cannot "
                             "reproduce")
        self.cfg = cfg
        self.scenario = scenario
        self.rng = np.random.default_rng(cfg.seed)
        self.time = 0.0
        self.round = 0
        self.ready = np.ones(cfg.n_clients, dtype=bool)
        lat_dtype = np.float32 if cfg.rng == "counter" else np.float64
        self.busy_lat = np.zeros(cfg.n_clients, dtype=lat_dtype)
        self.model_round = np.zeros(cfg.n_clients, dtype=np.int64)
        self.restart_ids = np.arange(cfg.n_clients, dtype=np.int64)
        k = cfg.n_clients
        traits = (None if scenario is None
                  else counter_traits(cfg.seed, k, scenario, "cpu"))
        if latencies is None:
            if scenario is None:
                def latencies(r):
                    return counter_latencies(cfg.seed, r, k, cfg.lat_lo,
                                             cfg.lat_hi, "cpu").numpy()
            else:
                def latencies(r):
                    return counter_scenario_latencies(
                        cfg.seed, r, k, cfg.lat_lo, cfg.lat_hi, scenario,
                        traits.mu, "cpu").numpy()
        if masks is None and scenario is not None:
            def masks(t):
                return tuple(m.numpy() for m in counter_scenario_masks(
                    cfg.seed, t, k, scenario, traits.phase, "cpu"))
        self._latencies = latencies
        self._masks = masks

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
        the ids with b_k = 1 at this slot (under a scenario also available
        and not dropped), and s_k for every client (0 for the others).
        ``restart_ids`` is refreshed."""
        self.ready |= slot_ready(self.busy_lat, self.model_round, self.round,
                                 self.cfg.delta_t)
        if self.scenario is None or not self.scenario.has_masks:
            upl = restart = self.ready
        else:
            avail, drop = (np.asarray(m, dtype=bool)
                           for m in self._masks(self.round))
            upl = self.ready & avail & ~drop
            restart = self.ready & avail
        stal = np.where(upl, self.round - self.model_round, 0)
        uploaders = np.flatnonzero(upl).astype(np.int64)
        self.restart_ids = np.flatnonzero(restart).astype(np.int64)
        self.round += 1
        self.time = self.round * self.cfg.delta_t
        return uploaders, stal.astype(np.int64)

    def sync_round_time(self, n_participants: int) -> float:
        """A synchronous round lasts as long as the slowest of its
        ``n_participants`` latency draws."""
        return float(np.max(self._draw_latency(n_participants)))
