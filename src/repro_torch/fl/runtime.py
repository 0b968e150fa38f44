"""The PAOTA aggregation period as one function on device tensors.

Port of the dense, raveled, f32 path of ``repro.fl.runtime``:
``paota_round_step`` takes a ``RoundCarry`` and returns the next one, with
the stages in the reference's order — scheduler advance, eq.-25 factors
(sweep 1 of the delta plane: ``repro_torch.kernels.ops.round_stats``),
water-filling P2, channel and power cap (7), AirComp (sweep 2:
``repro_torch.kernels.ops.superpose_normalize``), zero-uploader guarded
update, broadcast and local SGD. ``scan_rounds`` is the reference's
``lax.scan`` as a Python loop.

Nothing in a round reads a device value on the host: the round counter is
a Python int (it is control state, known without the device), and the
per-round metrics stay 0-d device tensors until ``scan_rounds`` stacks
them for one copy per ``advance``.

Randomness comes from a draw source with four methods — ``latencies(r)``,
``channel(t)``, ``noise(t)``, ``batch_plan(r)``: ``CounterDraws`` keys a
``torch.Generator`` on (seed, round, tag) for every draw, so chunking an
``advance`` never changes the trajectory; ``ArrayDraws`` replays given
tensors, which is how the tests feed the reference's own draws to the port.

Left out (the reference's cohort, compressed, scenario, fault, screen,
rollback, grouped, TP and pytree branches): FusedPAOTA refuses each knob.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (guarded_global_update,
                                          paota_aggregate_stacked)
from repro_torch.core.aircomp import (VARSIGMA_MIN, ChannelConfig,
                                      effective_power_cap,
                                      sample_channel_gains)
from repro_torch.core.boxqp import waterfill_beta
from repro_torch.core.power_control import (power_from_beta,
                                            similarity_factor,
                                            staleness_factor)
from repro_torch.core.scheduler import (TAG_NOISE, counter_latencies,
                                        round_tag_generator, sched_advance,
                                        sched_broadcast)
from repro_torch.data.pipeline import counter_batch_plan
from repro_torch.device import f32, resolve_device
from repro_torch.kernels.ops import round_stats

# per-round metrics that live on the device, in the order they are stacked
DEVICE_METRICS = ("n_participants", "mean_staleness", "beta_mean",
                  "varsigma", "p2_objective")


@dataclass
class RoundCarry:
    """PAOTA state threaded through the rounds (dense, raveled, f32)."""
    t: int                      # scheduler round counter (host-side)
    time: float                 # simulated clock in seconds (report-only)
    ready: torch.Tensor         # (K,) bool: b_k at the aggregation slot
    busy_lat: torch.Tensor      # (K,) f32: latency draw of the current
                                # local training
    model_round: torch.Tensor   # (K,) i32: round each client trains on
    global_vec: torch.Tensor    # (d,) f32: w_g^t
    prev_global: torch.Tensor   # (d,) f32: w_g^{t-1}
    pending: Optional[torch.Tensor]  # (K, d) in-flight local models, or
                                # None under transmit='delta'
    deltas: torch.Tensor        # (K, d): pending - start model


class RoundCfg(NamedTuple):
    """Static per-federation constants of the round."""
    omega: float                # staleness constant Omega
    c1: float                   # L eps^2 K   (P2 term-d scale)
    c0: float                   # 2 L d sigma_n^2 (P2 term-e numerator)
    p_max_watts: float          # per-client power budget P_max
    delta_t: float              # aggregation period (seconds)
    transmit_delta: bool        # True: clients transmit dw_k; False: w_k


class RoundStreams(NamedTuple):
    """How the federation trains and draws its randomness."""
    local_train: Callable       # (global (d,), round) -> (K, d) trained
    latencies: Callable         # (round) -> (K,) f32 latency draws
    channel: Callable           # (round) -> (K,) f32 |h_k|
    noise: Callable             # (round) -> (d,) f32 sigma_n * N(0, 1)


# ---------------------------------------------------------------------------
# draw sources
# ---------------------------------------------------------------------------

class CounterDraws:
    """Counter-keyed draws on ``device``: each is a pure function of
    (seed, round, tag) through a fresh ``torch.Generator``; the batch plan's
    row k is a pure function of (seed, round, k)."""

    def __init__(self, sched_seed: int, srv_seed: int, device, *, k: int,
                 d: int, lat_lo: float, lat_hi: float, chan: ChannelConfig,
                 n_samples, local_steps: int, batch_size: int):
        self.device = resolve_device(device)
        self.sched_seed, self.srv_seed = int(sched_seed), int(srv_seed)
        self.k, self.d = k, d
        self.lat_lo, self.lat_hi = lat_lo, lat_hi
        self.chan = chan
        self.sigma_n = chan.sigma_n
        self.n_samples = torch.as_tensor(np.asarray(n_samples, np.int64),
                                         device=self.device)
        self.local_steps, self.batch_size = local_steps, batch_size

    def latencies(self, r: int) -> torch.Tensor:
        return counter_latencies(self.sched_seed, r, self.k, self.lat_lo,
                                 self.lat_hi, self.device)

    def channel(self, t: int) -> torch.Tensor:
        return sample_channel_gains(self.srv_seed, t, self.k, self.chan,
                                    self.device)

    def noise(self, t: int) -> torch.Tensor:
        gen = round_tag_generator(self.srv_seed, t, TAG_NOISE, self.device)
        z = torch.randn((self.d,), generator=gen, device=self.device,
                        dtype=torch.float32)
        return f32(self.sigma_n) * z

    def batch_plan(self, r: int) -> torch.Tensor:
        return counter_batch_plan(self.srv_seed, r, self.n_samples,
                                  self.local_steps, self.batch_size)


class ArrayDraws:
    """Replays given draws: ``latencies`` (R+1, K) and ``batch_plan``
    (R+1, K, M, B) for rounds 0..R, ``channel`` (R, K) and ``noise`` (R, d)
    for rounds 0..R-1 — the noise already scaled by sigma_n."""

    def __init__(self, latencies, channel, noise, batch_plan, device=None):
        self.device = resolve_device(device)

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        self._lat = put(latencies, torch.float32)
        self._chan = put(channel, torch.float32)
        self._noise = put(noise, torch.float32)
        self._plan = put(batch_plan, torch.int64)

    def _at(self, arr, r: int, what: str):
        if not 0 <= r < arr.shape[0]:
            raise IndexError(f"ArrayDraws holds {what} for rounds "
                             f"0..{arr.shape[0] - 1}, asked for round {r}")
        return arr[r]

    def latencies(self, r: int):
        return self._at(self._lat, r, "latencies")

    def channel(self, t: int):
        return self._at(self._chan, t, "channel gains")

    def noise(self, t: int):
        return self._at(self._noise, t, "noise")

    def batch_plan(self, r: int):
        return self._at(self._plan, r, "batch plans")


# ---------------------------------------------------------------------------
# stage helpers
# ---------------------------------------------------------------------------

def round_factors(deltas, payload, global_vec, prev_global, stal, omega,
                  eps=1e-12):
    """Stage 2, one sweep of the delta plane (and the payload plane when
    given): eq.-25 staleness factors rho_k, similarity factors theta_k, and
    the payload sq-norms the power constraint (7) needs. ``payload=None``
    means the payload IS the deltas (transmit='delta').

    Returns (rho, theta, w_norm2)."""
    gdir = global_vec - prev_global
    dots, dn2, pn2, gn2 = round_stats(deltas, gdir, payload)
    eps = f32(eps)
    den = torch.sqrt(torch.clamp_min(dn2, eps) * torch.clamp_min(gn2, eps))
    cos = torch.where(torch.sqrt(gn2) < f32(1e-12), torch.zeros_like(dots),
                      dots / den)
    theta = similarity_factor(cos)
    rho = staleness_factor(stal, omega)
    return rho, theta, (dn2 if payload is None else pn2)


def constraint7_powers(powers, h, p_max: float, w_norm2):
    """Stage 4: p_k <- min(p_k, |h_k| sqrt(P_max / ||w_k||^2)), with the
    payload norms from the stage-2 sweep."""
    return torch.minimum(powers, effective_power_cap(w_norm2, h, p_max))


# ---------------------------------------------------------------------------
# the round transition
# ---------------------------------------------------------------------------

def paota_round_step(carry: RoundCarry, *, rcfg: RoundCfg,
                     streams: RoundStreams):
    """One PAOTA aggregation period. Returns (next carry, metrics), the
    metrics being 0-d device tensors named in ``DEVICE_METRICS``."""
    t = carry.t
    # the reference's (t + 1).astype(f32) * f32(delta_t), on the host
    time = float(np.float32(t + 1) * np.float32(rcfg.delta_t))

    # 1. scheduler advance: who finished inside this period, staleness
    ready, stal = sched_advance(carry.ready, carry.busy_lat,
                                carry.model_round, t, rcfg.delta_t)
    b = ready.to(torch.float32)
    stal = stal.to(torch.float32)        # 0 for every client not ready

    # 2. eq.-25 factors + payload norms: sweep 1 of 2 over the delta plane
    payload = carry.deltas if rcfg.transmit_delta else carry.pending
    rho, theta, w_norm2 = round_factors(
        carry.deltas, None if rcfg.transmit_delta else carry.pending,
        carry.global_vec, carry.prev_global, stal, rcfg.omega)

    # 3. P2 -> beta -> powers
    p_max = torch.full_like(b, f32(rcfg.p_max_watts))
    beta, p2_obj = waterfill_beta(rho, theta, p_max, b, rcfg.c1, rcfg.c0)
    powers = power_from_beta(beta, rho, theta, p_max)

    # 4. power constraint (7) under the sampled channel
    powers = constraint7_powers(powers, streams.channel(t), rcfg.p_max_watts,
                                w_norm2)

    # 5+6. AirComp superposition + AWGN + normalization (sweep 2 of 2) and
    # the zero-uploader-guarded update
    agg, varsigma = paota_aggregate_stacked(payload, powers, b,
                                            streams.noise(t))
    new_global, new_prev = guarded_global_update(
        carry.global_vec, carry.prev_global, agg, varsigma,
        delta=rcfg.transmit_delta)

    # 7. broadcast w^{r+1} to the uploaders, who restart local training;
    # their delta rows are refreshed as f32 trained - w_g^{r+1}
    t_next = t + 1
    n_ready, n_lat, n_model = sched_broadcast(
        ready, carry.busy_lat, carry.model_round, ready,
        streams.latencies(t_next), t_next)
    trained = streams.local_train(new_global, t_next)
    rows = ready[:, None]
    if carry.pending is not None:
        pending = torch.where(rows, trained, carry.pending)
        deltas = torch.where(rows, pending - new_global, carry.deltas)
    else:
        pending = None
        deltas = torch.where(rows, trained - new_global, carry.deltas)

    n_upl = b.sum()
    denom = torch.clamp_min(n_upl, 1.0)
    out = {
        "n_participants": n_upl,
        "mean_staleness": (stal * b).sum() / denom,
        "beta_mean": (beta * b).sum() / denom,
        "varsigma": torch.where(varsigma > f32(VARSIGMA_MIN), varsigma,
                                torch.zeros_like(varsigma)),
        # a zero-uploader P2 is vacuous: report inf, like the reference
        "p2_objective": torch.where(n_upl > 0, p2_obj,
                                    torch.full_like(p2_obj, float("inf"))),
    }
    nxt = RoundCarry(t=t_next, time=time, ready=n_ready, busy_lat=n_lat,
                     model_round=n_model, global_vec=new_global,
                     prev_global=new_prev, pending=pending, deltas=deltas)
    return nxt, out


def init_round_carry(vec, *, streams: RoundStreams,
                     keep_pending: bool = True) -> RoundCarry:
    """Round-0 kick-off: broadcast w_g^0 to every client and run their
    local training. ``keep_pending=False`` (transmit='delta') carries the
    delta plane only."""
    trained = streams.local_train(vec, 0)
    k = trained.shape[0]
    return RoundCarry(
        t=0, time=0.0,
        ready=torch.zeros((k,), dtype=torch.bool, device=vec.device),
        busy_lat=streams.latencies(0),
        model_round=torch.zeros((k,), dtype=torch.int32, device=vec.device),
        global_vec=vec, prev_global=vec,
        pending=trained if keep_pending else None,
        deltas=trained - vec)


def scan_rounds(carry: RoundCarry, n_rounds: int, *, rcfg: RoundCfg,
                streams: RoundStreams):
    """``n_rounds`` periods in a Python loop. Returns (carry, metrics):
    ``metrics`` maps each of ``DEVICE_METRICS`` to an (n_rounds,) device
    tensor, plus ``"time"`` to a host list."""
    outs = {k: [] for k in DEVICE_METRICS}
    times = []
    for _ in range(n_rounds):
        carry, out = paota_round_step(carry, rcfg=rcfg, streams=streams)
        for k in DEVICE_METRICS:
            outs[k].append(out[k])
        times.append(carry.time)
    stacked = {k: torch.stack(v) for k, v in outs.items()}
    stacked["time"] = times
    return carry, stacked
