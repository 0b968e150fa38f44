"""The PAOTA aggregation period as one function on device tensors.

Port of the single-device paths of ``repro.fl.runtime``:
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

Active-cohort mode (``RoundCfg.cohort_size`` m >= 1,
``_cohort_round_step``) splits the carry into a dense (K,) client-state
plane (scheduler bits, latency draws, model rounds, and the scenario
masks) and an (m, ...) payload plane for the in-flight cohort only
(``slot_client`` / ``slot_live``); freed slots refill from the available
idle pool by priority. With ``RoundCfg.compress`` the slots carry an
(m, s) compressed plane on per-slot supports, with error-feedback
residuals parked on a (K, s) plane across slot turnover; the stats run
plain on the compressed rows and AirComp through the ``gather_superpose``
kernel. At s >= d the compression is statically the identity and the
dense stages run, bit-identical to the uncompressed cohort.

Randomness comes from a draw source: ``latencies(r)``, ``channel(t)``,
``noise(t)`` and ``batch_plan(r)``, and for the cohort, scenario and
compressed branches ``sched_priority(r)``, ``scenario_masks(t)``,
``compress_mask(t)``, ``quant_uniform(t)`` and the static ``traits``.
``CounterDraws`` keys a ``torch.Generator`` on (seed, round, tag) for every
draw, so chunking an ``advance`` never changes the trajectory;
``ArrayDraws`` replays given tensors, which is how the tests feed the
reference's own draws to the port.

The model is a raveled (d,) vector with (K, d) planes, or a params dict
whose (K, ...) leaves are one contiguous tensor each (the pytree carry):
the sweeps then run once per leaf, and the noise (d,) splits per leaf in
leaf order. ``RoundCfg.pending_dtype="bfloat16"`` stores the (K, ...)
planes in bf16: deltas are formed in f32 from the f32 trained rows before
the cast, every sum accumulates in f32 and the globals stay f32.
``RoundCfg.screen`` masks rows whose sweep-1 stats are non-finite (or
whose payload norm passes ``screen_max_norm``) out of the superposition,
zeroed before sweep 2 (0 * NaN is NaN); ``divergence_factor`` rolls w_g
back to the carry's last good global when its norm jumps. Each knob left
off keeps the round's program as it was without it.

The sharded round (``repro_torch.fl.sharded.ShardedPAOTA``) runs the same
step on each rank's rows of the federation, with a ``reducer``
(``repro_torch.launch.collectives.Reducer``) where the reference calls
``psum`` / ``pmin`` / ``pmax``: the superposition is one all-reduce of
the flat (d_total + 1,) partial (``paota_partial_stacked``, the noise
joining after it), the water-filling's sums and the round's metric sums
are small packed all-reduces. Its two topologies are the reference's:
``GroupTopology`` (grouped aggregation: ``scan_windows`` runs whole
windows of ``RoundCfg.group_period`` periods, each pod superposing its
own clients into the carry's ``held`` partial, and one cross-pod
all-reduce at the window's sync) and ``TPTopology``
(``repro_torch.sharding.tp``: the planes hold each rank's TP block of
every leaf). ``reducer=None`` is the single-device round, op for op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (guarded_global_update,
                                          paota_aggregate_compressed,
                                          paota_aggregate_stacked,
                                          paota_finalize_stacked,
                                          paota_partial_stacked)
from repro_torch.core.aircomp import (VARSIGMA_MIN, ChannelConfig,
                                      effective_power_cap,
                                      sample_channel_gains)
from repro_torch.core.boxqp import waterfill_beta
from repro_torch.core.compress import (dequantize_int8, ef_residual,
                                       gather_rows, quantize_int8_stochastic,
                                       scatter_rows, sparsify, topk_support)
from repro_torch.core.power_control import (client_sq_norms,
                                            global_sq_norm,
                                            power_from_beta,
                                            similarity_factor,
                                            staleness_factor)
from repro_torch.core.scheduler import (TAG_COMPRESS, TAG_FAULT, TAG_NOISE,
                                        TAG_QUANT, TAG_SCHED, ScenarioConfig,
                                        ScenarioTraits, counter_latencies,
                                        counter_scenario_latencies,
                                        counter_scenario_masks,
                                        counter_traits, counter_uniform,
                                        round_tag_generator,
                                        sched_advance, sched_broadcast)
from repro_torch.data.pipeline import counter_batch_plan
from repro_torch.device import f32, resolve_device
from repro_torch.kernels.ops import (round_stats, round_stats_compressed,
                                     round_stats_tp)
from repro_torch.sharding.tp import tp_block
from repro_torch.tree import tree_leaves, tree_map

# per-round metrics that live on the device, in the order they are stacked
DEVICE_METRICS = ("n_participants", "mean_staleness", "beta_mean",
                  "varsigma", "p2_objective")
# their screening and rollback counterparts, on the device only while the
# branch is on (0 otherwise, with nothing computed)
FAULT_METRICS = ("n_screened", "rolled_back")


@dataclass
class RoundCarry:
    """PAOTA state threaded through the rounds. The model quantities are a
    (d,) vector and (K, d) planes, or params dicts of such leaves; the
    planes are stored in ``RoundCfg.pending_dtype``, the globals in
    f32."""
    t: int                      # scheduler round counter (host-side)
    time: float                 # simulated clock in seconds (report-only)
    ready: torch.Tensor         # (K,) bool: b_k at the aggregation slot
    busy_lat: torch.Tensor      # (K,) f32: latency draw of the current
                                # local training
    model_round: torch.Tensor   # (K,) i32: round each client trains on
    global_vec: torch.Tensor    # (d,) f32: w_g^t
    prev_global: torch.Tensor   # (d,) f32: w_g^{t-1}
    pending: Optional[torch.Tensor]  # (K, d) in-flight local models, or
                                # None under transmit='delta'; (m, d) slot
                                # rows in active-cohort mode
    deltas: torch.Tensor        # (K, d): pending - start model; (m, d) slot
                                # rows in cohort mode, or the (m, s)
                                # compressed values (f32 / bf16 / int8)
    # active-cohort mode only (RoundCfg.cohort_size m >= 1); None otherwise
    slot_client: Optional[torch.Tensor] = None  # (m,) i32: each slot's
                                # client (a dead slot keeps its last one)
    slot_live: Optional[torch.Tensor] = None    # (m,) bool: slot holds a
                                # client in flight (False: b = 0 throughout)
    # compressed cohort payloads only (RoundCfg.compress)
    slot_idx: Optional[torch.Tensor] = None     # (m, s) i32 supports
    slot_scale: Optional[torch.Tensor] = None   # (m,) f32 int8 scales
    slot_resid: Optional[torch.Tensor] = None   # (m, s) f32 EF residuals
    slot_resid_idx: Optional[torch.Tensor] = None  # (m, s) i32 supports
    resid_val: Optional[torch.Tensor] = None    # (K, s) f32 parked EF
                                # residuals, indexed by client
    resid_idx: Optional[torch.Tensor] = None    # (K, s) i32 parked supports
    # divergence rollback only (RoundCfg.divergence_factor > 0)
    good_global: Optional[torch.Tensor] = None  # last global that passed
                                # the norm check (vector or params dict)
    good_norm2: Optional[torch.Tensor] = None   # f32 ||good_global||^2
    # grouped aggregation only (RoundCfg.group_period >= 1)
    held: Optional[torch.Tensor] = None  # (d_total + 1,) f32: the pod's
                                # staleness-weighted partials of the window
                                # so far (the same on every rank of a pod)


class RoundCfg(NamedTuple):
    """Static per-federation constants of the round."""
    omega: float                # staleness constant Omega
    c1: float                   # L eps^2 K   (P2 term-d scale)
    c0: float                   # 2 L d sigma_n^2 (P2 term-e numerator)
    p_max_watts: float          # per-client power budget P_max
    delta_t: float              # aggregation period (seconds)
    transmit_delta: bool        # True: clients transmit dw_k; False: w_k
    cohort_size: int = 0        # 0: dense carry; m >= 1: at most m clients
                                # in flight, payload rows for them only
    compress: str = ""          # "" | "topk" | "randmask" (cohort slots
                                # carry an (m, s) plane; transmit='delta')
    compress_s: int = 0         # static compressed width s; s >= d is the
                                # identity (dense stages, bit-identical)
    slot_dtype: str = ""        # compressed value storage: "float32" |
                                # "bfloat16" | "int8" (absmax + dither)
    error_feedback: bool = False  # carry the EF residual planes
    pending_dtype: str = "float32"  # (K, ...) plane storage: "float32" |
                                # "bfloat16" (f32 accumulation throughout)
    screen: bool = False        # mask non-finite (and norm-fenced) rows
                                # out of the superposition
    screen_max_norm: float = 0.0  # norm fence: ||payload|| above it is
                                # screened too (0: finite-only)
    divergence_factor: float = 0.0  # roll back when ||w_g|| passes factor *
                                # max(||good||, 1); 0 = off
    group_period: int = 0       # grouped aggregation: N periods a window
                                # (0: flat, every period a sync)


class GroupTopology(NamedTuple):
    """The mesh-axis split of grouped aggregation."""
    pod_axes: tuple             # client axes indexing the pods: the sync's
                                # all-reduce crosses them once a window
    intra_axes: tuple           # client axes inside a pod (may be empty:
                                # every shard its own pod)
    intra_shards: int           # ranks a pod spans: the held partial's
                                # replication count


class RoundStreams(NamedTuple):
    """How the federation trains and draws its randomness. A callback the
    configuration does not use is None, so a run that asks for it fails."""
    local_train: Callable       # (global (d,), round) -> (K, d) trained
    latencies: Callable         # (round) -> (K,) f32 latency draws
    channel: Callable           # (round) -> (K,) f32 |h_k|
    noise: Callable             # (round) -> (d,) f32 sigma_n * N(0, 1),
                                # or None on a noiseless channel
    scenario: Optional[Callable] = None  # (round) -> (K,) bool
                                # (available, dropped) masks
    cohort_train: Optional[Callable] = None  # (global, round, (m,) ids)
                                # -> (m, d) trained rows of those clients
    sched_priority: Optional[Callable] = None  # (round) -> (K,) f32
                                # scores; the highest idle available
                                # clients fill freed slots
    compress_mask: Optional[Callable] = None  # (round) -> (s,) i32 shared
                                # randmask support
    quant_uniform: Optional[Callable] = None  # (round) -> (m, s) f32
                                # U[0, 1) int8 dither


# ---------------------------------------------------------------------------
# draw sources
# ---------------------------------------------------------------------------

class CounterDraws:
    """Counter-keyed draws on ``device``: each is a pure function of
    (seed, round, tag) through a fresh ``torch.Generator``; the batch plan's
    row k is a pure function of (seed, round, k). The scheduler seed keys
    latencies, scenario masks, slot priorities and the static traits; the
    server seed keys channel, noise, batch plans, the randmask support and
    the int8 dither, the roles the reference's two keys play. The fault
    uniforms are keyed on the scheduler seed under ``TAG_FAULT``, the fade
    mask's on a sub-stream of it (fold 1), as the reference's are.

    ``scenario`` (a ``ScenarioConfig``) shapes the latencies, adds the
    masks and draws the static ``traits`` once; ``m`` and ``s`` are the
    cohort size and compressed width the int8 dither is drawn for."""

    def __init__(self, sched_seed: int, srv_seed: int, device, *, k: int,
                 d: int, lat_lo: float, lat_hi: float, chan: ChannelConfig,
                 n_samples, local_steps: int, batch_size: int,
                 scenario: Optional[ScenarioConfig] = None, m: int = 0,
                 s: int = 0):
        self.device = resolve_device(device)
        self.sched_seed, self.srv_seed = int(sched_seed), int(srv_seed)
        self.k, self.d, self.m, self.s = k, d, m, s
        self.lat_lo, self.lat_hi = lat_lo, lat_hi
        self.chan = chan
        self.sigma_n = chan.sigma_n
        self.n_samples = torch.as_tensor(np.asarray(n_samples, np.int64),
                                         device=self.device)
        self.local_steps, self.batch_size = local_steps, batch_size
        self.scenario = scenario
        self.traits = (None if scenario is None else
                       counter_traits(self.sched_seed, k, scenario,
                                      self.device))

    def latencies(self, r: int) -> torch.Tensor:
        if self.scenario is None:
            return counter_latencies(self.sched_seed, r, self.k,
                                     self.lat_lo, self.lat_hi, self.device)
        return counter_scenario_latencies(
            self.sched_seed, r, self.k, self.lat_lo, self.lat_hi,
            self.scenario, self.traits.mu, self.device)

    def channel(self, t: int) -> torch.Tensor:
        return sample_channel_gains(self.srv_seed, t, self.k, self.chan,
                                    self.device)

    def noise(self, t: int) -> torch.Tensor:
        if self.sigma_n == 0.0:                  # a noiseless channel
            return torch.zeros((self.d,), dtype=torch.float32,
                               device=self.device)
        gen = round_tag_generator(self.srv_seed, t, TAG_NOISE, self.device)
        z = torch.randn((self.d,), generator=gen, device=self.device,
                        dtype=torch.float32)
        return f32(self.sigma_n) * z

    def batch_plan(self, r: int) -> torch.Tensor:
        batch_k = None if self.traits is None else self.traits.batch_k
        return counter_batch_plan(self.srv_seed, r, self.n_samples,
                                  self.local_steps, self.batch_size,
                                  batch_sizes=batch_k)

    def scenario_masks(self, t: int):
        return counter_scenario_masks(self.sched_seed, t, self.k,
                                      self.scenario, self.traits.phase,
                                      self.device)

    def sched_priority(self, r: int) -> torch.Tensor:
        return counter_uniform(self.sched_seed, r, TAG_SCHED, (self.k,),
                               self.device)

    def compress_mask(self, t: int) -> torch.Tensor:
        gen = round_tag_generator(self.srv_seed, t, TAG_COMPRESS,
                                  self.device)
        perm = torch.randperm(self.d, generator=gen, device=self.device)
        return perm[:self.s].to(torch.int32)

    def quant_uniform(self, t: int) -> torch.Tensor:
        return counter_uniform(self.srv_seed, t, TAG_QUANT,
                               (self.m, self.s), self.device)

    def fault_uniform(self, r: int) -> torch.Tensor:
        return counter_uniform(self.sched_seed, r, TAG_FAULT, (self.k,),
                               self.device)

    def fade_uniform(self, t: int) -> torch.Tensor:
        return counter_uniform(self.sched_seed, t, TAG_FAULT, (self.k,),
                               self.device, fold=1)


class ArrayDraws:
    """Replays given draws: ``latencies`` (R+1, K) and ``batch_plan``
    (R+1, K, M, B) for rounds 0..R, ``channel`` (R, K) and ``noise`` (R, d)
    for rounds 0..R-1 — the noise already scaled by sigma_n. The cohort,
    scenario and compressed branches add ``priority`` (R, K), ``avail`` and
    ``drop`` (R, K) masks, ``compress_mask`` (R+1, s), ``quant_uniform``
    (R+1, m, s), and the static ``traits`` (a ``ScenarioTraits``); fault
    injection adds the payload-fault uniforms ``fault_uniform`` (R+1, K)
    and the deep-fade uniforms ``fade_uniform`` (R, K). A draw left None
    is one the run must not ask for (a host-mode server draws its
    latencies and plans on the host)."""

    def __init__(self, latencies=None, channel=None, noise=None,
                 batch_plan=None, device=None, *, priority=None,
                 avail=None, drop=None, compress_mask=None,
                 quant_uniform=None, traits: Optional[ScenarioTraits] = None,
                 fault_uniform=None, fade_uniform=None):
        self.device = resolve_device(device)

        def put(a, dtype):
            if a is None:
                return None
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        self._lat = put(latencies, torch.float32)
        self._chan = put(channel, torch.float32)
        self._noise = put(noise, torch.float32)
        self._plan = put(batch_plan, torch.int64)
        self._prio = put(priority, torch.float32)
        self._avail = put(avail, torch.bool)
        self._drop = put(drop, torch.bool)
        self._mask = put(compress_mask, torch.int32)
        self._quant = put(quant_uniform, torch.float32)
        self._fault = put(fault_uniform, torch.float32)
        self._fade = put(fade_uniform, torch.float32)
        self.traits = None if traits is None else ScenarioTraits(
            *(put(a, dt) for a, dt in zip(
                traits, (torch.int32, torch.float32, torch.int32,
                         torch.int32))))

    def _at(self, arr, r: int, what: str):
        if arr is None:
            raise IndexError(f"ArrayDraws was given no {what}")
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

    def scenario_masks(self, t: int):
        return (self._at(self._avail, t, "availability masks"),
                self._at(self._drop, t, "dropout masks"))

    def sched_priority(self, r: int):
        return self._at(self._prio, r, "slot priorities")

    def compress_mask(self, t: int):
        return self._at(self._mask, t, "randmask supports")

    def quant_uniform(self, t: int):
        return self._at(self._quant, t, "int8 dither uniforms")

    def fault_uniform(self, r: int):
        return self._at(self._fault, r, "payload-fault uniforms")

    def fade_uniform(self, t: int):
        return self._at(self._fade, t, "deep-fade uniforms")


# ---------------------------------------------------------------------------
# stage helpers
# ---------------------------------------------------------------------------

def round_factors(deltas, payload, global_vec, prev_global, stal, omega,
                  eps=1e-12, tp=None, reducer=None):
    """Stage 2, one sweep of the delta plane (and the payload plane when
    given): eq.-25 staleness factors rho_k, similarity factors theta_k, and
    the payload sq-norms the power constraint (7) needs. ``payload=None``
    means the payload IS the deltas (transmit='delta'). With ``tp`` the
    planes hold TP-local blocks and the sweep closes with one small
    all-reduce over the TP ranks (``ops.round_stats_tp``, on ``reducer``).

    Returns (rho, theta, w_norm2)."""
    gdir = tree_map(torch.sub, global_vec, prev_global)
    if tp is not None:
        dots, dn2, pn2, gn2 = round_stats_tp(deltas, gdir, payload, tp,
                                             reducer)
    else:
        dots, dn2, pn2, gn2 = round_stats(deltas, gdir, payload)
    eps = f32(eps)
    den = torch.sqrt(torch.clamp_min(dn2, eps) * torch.clamp_min(gn2, eps))
    cos = torch.where(torch.sqrt(gn2) < f32(1e-12), torch.zeros_like(dots),
                      dots / den)
    theta = similarity_factor(cos)
    rho = staleness_factor(stal, omega)
    return rho, theta, (dn2 if payload is None else pn2)


def eq25_factors(pending, starts, global_vec, prev_global, stal, omega):
    """Stage 2 on the host server's state (pending, starts): the deltas
    are pending - starts, then the one-sweep ``round_factors`` (no payload:
    the server's constraint (7) computes its own norms). Returns
    (deltas, rho, theta)."""
    deltas = pending - starts
    rho, theta, _ = round_factors(deltas, None, global_vec, prev_global,
                                  stal, omega)
    return deltas, rho, theta


def compressed_round_factors(values, idx, resid, resid_idx, global_vec,
                             prev_global, stal, omega, scale=None,
                             eps=1e-12):
    """Stage 2 over the compressed cohort plane: the stats run on the
    (m, s) transmitted values and the EF residuals on their supports
    (``ops.round_stats_compressed``), never a dense (m, d) row. theta sees
    each slot's full reconstruction <v + e, gdir>; the payload norm is
    ||v||^2, the transmitted energy that (7) caps.

    Returns (rho, theta, w_norm2)."""
    gdir = global_vec - prev_global
    dots, dn2, pn2, gn2 = round_stats_compressed(values, idx, resid,
                                                 resid_idx, gdir,
                                                 scale=scale)
    eps = f32(eps)
    den = torch.sqrt(torch.clamp_min(dn2, eps) * torch.clamp_min(gn2, eps))
    cos = torch.where(torch.sqrt(gn2) < f32(1e-12), torch.zeros_like(dots),
                      dots / den)
    return staleness_factor(stal, omega), similarity_factor(cos), pn2


def _compress_plane(comp, *, rcfg: RoundCfg, streams: RoundStreams, t: int):
    """Compress freshly trained (m, d) f32 rows (EF-compensated deltas)
    into the slot planes. Support: s >= d is the identity (an arange
    support, the dense rows kept whole), top-k takes each row's s
    largest-|.| coordinates, randmask the round's shared mask. Storage:
    f32, bf16 (round trip) or int8 (per-row absmax, stochastic rounding
    on the round's dither). The EF residual is the exact f32 complement
    of the row against its stored reconstruction, re-sparsified to s.

    Returns (stored (m, s), idx (m, s) i32, scale (m,) | None,
    resid (m, s) | None, resid_idx (m, s) | None)."""
    m, d = comp.shape
    s = rcfg.compress_s
    if s >= d:
        idx = torch.arange(d, dtype=torch.int32,
                           device=comp.device).repeat(m, 1)
        vals = comp
    elif rcfg.compress == "topk":
        idx = topk_support(comp, s)
        vals = gather_rows(comp, idx)
    else:                                                   # randmask
        idx = streams.compress_mask(t)[None].repeat(m, 1)
        vals = gather_rows(comp, idx)
    scale = None
    if rcfg.slot_dtype == "int8":
        stored, scale = quantize_int8_stochastic(vals,
                                                 streams.quant_uniform(t))
        v_hat = dequantize_int8(stored, scale)
    elif rcfg.slot_dtype == "bfloat16":
        stored = vals.to(torch.bfloat16)
        v_hat = stored.float()
    else:
        stored = v_hat = vals
    if not rcfg.error_feedback:
        return stored, idx, scale, None, None
    e_val, e_idx = sparsify(ef_residual(comp, idx, v_hat), s)
    return stored, idx, scale, e_val, e_idx


def _scatter_any(k: int, rows: torch.Tensor, flags: torch.Tensor):
    """(K,) bool: client c is set iff some slot j with ``flags[j]`` has
    ``rows[j] == c`` (the reference's ``zeros.at[rows].max(flags)``). A
    dead slot may repeat an id, so this reduces with max, never writes."""
    out = torch.zeros((k,), dtype=torch.int32, device=rows.device)
    return out.scatter_reduce(0, rows.long(), flags.to(torch.int32),
                              "amax") > 0


def _set_rows(plane: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              flags: torch.Tensor) -> torch.Tensor:
    """A copy of the (K, ...) ``plane`` with row ``rows[j]`` set to
    ``vals[j]`` for every slot j under ``flags`` (the reference's
    ``plane.at[where(flags, rows, K)].set(vals, mode="drop")``). The
    flagged rows are distinct; an unflagged slot may repeat a flagged
    slot's id, so every slot writes the value its row ends with and the
    duplicate writes agree."""
    k, m = plane.shape[0], rows.shape[0]
    rows = rows.long()
    slot = torch.where(flags, torch.arange(m, device=rows.device),
                       torch.full_like(rows, -1))
    owner = torch.full((k,), -1, dtype=torch.int64, device=rows.device)
    owner = owner.scatter_reduce(0, rows, slot, "amax")[rows]
    has = (owner >= 0).reshape((m,) + (1,) * (plane.dim() - 1))
    new = torch.where(has, vals[owner.clamp_min(0)], plane[rows])
    out = plane.clone()
    out[rows] = new
    return out


def constraint7_powers(powers, h, p_max: float, w_norm2=None, payload=None):
    """Stage 4: p_k <- min(p_k, |h_k| sqrt(P_max / ||w_k||^2)). The fused
    round passes the payload norms of its stage-2 sweep; the host server
    passes the (K, d) ``payload`` instead, whose norms are computed here
    (plain torch: the reference's einsum, no kernel)."""
    if w_norm2 is None:
        w_norm2 = client_sq_norms(payload)
    return torch.minimum(powers, effective_power_cap(w_norm2, h, p_max))


# divergence detector: a global whose norm sits below this floor compares
# against the floor (a near-zero initial model must be allowed to grow)
DIVERGENCE_NORM_FLOOR = 1.0


def _zero_rows(tree, ok):
    """The stacked tree with the rows failing ``ok`` set to +0.0, which
    sweep 2 must see before it runs: it computes b * p * x, and 0 * NaN
    is NaN. A screened row then adds exactly what a b = 0 row adds."""
    def leaf(l):
        m = ok.reshape((ok.shape[0],) + (1,) * (l.dim() - 1))
        return torch.where(m, l, torch.zeros((), dtype=l.dtype,
                                             device=l.device))
    return tree_map(leaf, tree)


def _divergence_rollback(new_global, new_prev, carry: RoundCarry,
                         rcfg: RoundCfg):
    """Post-update divergence detector: when ||w_g^new||^2 passes
    factor^2 * max(||good||^2, floor^2), or is not finite (the test is
    written so NaN lands on the diverged side), both w_g and prev_global
    return to the carry's last good global and the slot stays; otherwise
    the accepted global becomes the new last good one. Device selects
    only. Returns (global, prev, good_global, good_norm2, rolled_back)."""
    n_new = global_sq_norm(new_global)
    limit = f32(f32(rcfg.divergence_factor) ** 2) * torch.clamp_min(
        carry.good_norm2, f32(DIVERGENCE_NORM_FLOOR ** 2))
    diverged = ~(n_new <= limit)

    def sel(good, cand):
        return torch.where(diverged, good, cand)

    new_global = tree_map(sel, carry.good_global, new_global)
    new_prev = tree_map(sel, carry.good_global, new_prev)
    good_n2 = torch.where(diverged, carry.good_norm2, n_new)
    return new_global, new_prev, new_global, good_n2, diverged.float()


def _storage_dtype(rcfg: Optional[RoundCfg]) -> torch.dtype:
    name = "float32" if rcfg is None else rcfg.pending_dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _cast_rows(tree, dtype):
    return tree_map(lambda l: l.to(dtype), tree)


def _screen(payload, theta, w_norm2, b, rcfg: RoundCfg):
    """Stage 2b (``rcfg.screen``), read off the stats sweep the round
    already ran: a row with a NaN or Inf anywhere shows a non-finite theta
    or sq-norm, and ``screen_max_norm`` fences rows by their payload norm.
    Failing rows leave the superposition like phantom clients: b = 0, the
    payload row +0.0 (``_zero_rows``), and their theta and w_norm2 set to
    0, so the water-filling never meets a NaN (NaN * b survives b = 0).
    Returns (payload, theta, w_norm2, b, ok, n_screened)."""
    ok = torch.isfinite(theta) & torch.isfinite(w_norm2)
    if rcfg.screen_max_norm > 0.0:
        ok = ok & (w_norm2 <= f32(f32(rcfg.screen_max_norm) ** 2))
    zero = torch.zeros_like(theta)
    theta, w_norm2 = torch.where(ok, theta, zero), torch.where(ok, w_norm2,
                                                               zero)
    n_screened = (b * (~ok).float()).sum()
    b = b * ok.float()
    return (None if payload is None else _zero_rows(payload, ok), theta,
            w_norm2, b, ok, n_screened)


# ---------------------------------------------------------------------------
# the round transition
# ---------------------------------------------------------------------------

def _round_time(t: int, delta_t: float) -> float:
    """The reference's (t + 1).astype(f32) * f32(delta_t), on the host."""
    return float(np.float32(t + 1) * np.float32(delta_t))


def _upload_masks(ready, streams: RoundStreams, t: int):
    """(uploaders, restarters, available) at slot t. Without scenario
    masks all three are the ready set (``available`` None); with them an
    unavailable-but-ready client holds its update and stays ready, and a
    dropped upload is lost but the client still restarts."""
    if streams.scenario is None:
        return ready, ready, None
    avail, drop = streams.scenario(t)
    return ready & avail & ~drop, ready & avail, avail


def _metrics(b, stal, beta, varsigma, p2_obj, n_screened=None,
             rolled=None, reducer=None):
    """The round's metrics. With ``reducer`` the four sums over the
    clients (uploaders, sum stal b, sum beta b, screened) are this rank's
    and go through one packed all-reduce."""
    n_upl, s_stal, s_beta = b.sum(), (stal * b).sum(), (beta * b).sum()
    if reducer is not None:
        parts = [n_upl, s_stal, s_beta] + (
            [n_screened] if n_screened is not None else [])
        sums = reducer.sum(torch.stack(parts), tag="metrics")
        n_upl, s_stal, s_beta = sums[0], sums[1], sums[2]
        if n_screened is not None:
            n_screened = sums[3]
    denom = torch.clamp_min(n_upl, 1.0)
    out = {
        "n_participants": n_upl,
        "mean_staleness": s_stal / denom,
        "beta_mean": s_beta / denom,
        "varsigma": torch.where(varsigma > f32(VARSIGMA_MIN), varsigma,
                                torch.zeros_like(varsigma)),
        # a zero-uploader P2 is vacuous: report inf, like the reference
        "p2_objective": torch.where(n_upl > 0, p2_obj,
                                    torch.full_like(p2_obj, float("inf"))),
    }
    if n_screened is not None:
        out["n_screened"] = n_screened
    if rolled is not None:
        out["rolled_back"] = rolled
    return out


def paota_round_step(carry: RoundCarry, *, rcfg: RoundCfg,
                     streams: RoundStreams, reducer=None,
                     grouping: Optional[GroupTopology] = None,
                     window_j: int = 0, tp=None):
    """One PAOTA aggregation period. Returns (next carry, metrics), the
    metrics being 0-d device tensors named in ``DEVICE_METRICS``. With
    ``rcfg.cohort_size`` the active-cohort form runs
    (``_cohort_round_step``).

    ``reducer``: the (K,) and (K, ...) rows are this rank's clients and the
    reductions over clients cross ranks on the reducer's (client) axes.
    ``tp``: the planes hold TP-local blocks (module docstring). Grouped
    aggregation (``grouping`` with ``rcfg.group_period`` N >= 1):
    ``window_j`` is the period's place in its window. A non-sync period
    (j < N - 1) water-fills per pod, sums the pod's superposition over the
    intra-pod ranks and adds it to ``held`` weighted by the staleness
    factor of its age at the sync, rho(N - 1 - j); the global holds. The
    sync period adds held / intra_shards to its local partial and sends
    it through the window's one all-reduce over every client axis, then
    the noise and the division. At N = 1 held is 0 and the sync is the
    flat path, bit for bit."""
    if rcfg.cohort_size:
        if reducer is not None or grouping is not None or tp is not None:
            raise NotImplementedError(
                f"active-cohort mode (cohort_size={rcfg.cohort_size}) does "
                f"not compose with the sharded round (grouping or TP) in "
                f"the port yet: its slots are shard-local in the "
                f"reference; the nearest supported configuration is "
                f"cohort_size={rcfg.cohort_size} on FusedPAOTA, or the "
                f"sharded round with cohort_size=0")
        return _cohort_round_step(carry, rcfg=rcfg, streams=streams)
    if tp is not None and grouping is not None:
        raise NotImplementedError(
            f"grouped aggregation (group_period={rcfg.group_period}) does "
            f"not compose with intra-client TP (tp axes {tp.axes}) yet: "
            f"the held intra-pod partial is not TP-split; the nearest "
            f"supported configurations are group_period="
            f"{rcfg.group_period} with TP extent 1, or TP with "
            f"group_period=0")
    grouped = grouping is not None and rcfg.group_period >= 1
    sync = (not grouped) or window_j == rcfg.group_period - 1
    t = carry.t
    time = _round_time(t, rcfg.delta_t)

    # 1. scheduler advance: who finished inside this period, staleness;
    # the scenario masks gate who uploads and who restarts
    ready, stal = sched_advance(carry.ready, carry.busy_lat,
                                carry.model_round, t, rcfg.delta_t)
    upl, restart, _ = _upload_masks(ready, streams, t)
    b = upl.to(torch.float32)
    stal = torch.where(upl, stal, torch.zeros_like(stal)).to(torch.float32)

    # 2. eq.-25 factors + payload norms: sweep 1 of 2 over the delta plane
    payload = carry.deltas if rcfg.transmit_delta else carry.pending
    rho, theta, w_norm2 = round_factors(
        carry.deltas, None if rcfg.transmit_delta else carry.pending,
        carry.global_vec, carry.prev_global, stal, rcfg.omega, tp=tp,
        reducer=reducer)

    # 2b. screening: corrupt or fenced rows leave as phantom clients
    n_screened = None
    if rcfg.screen:
        payload, theta, w_norm2, b, _, n_screened = _screen(
            payload, theta, w_norm2, b, rcfg)

    # 3. P2 -> beta -> powers; at a grouped non-sync period only the pod's
    # clients superpose, so the water level is the pod's
    wf_reducer = reducer if sync or reducer is None else (
        reducer.over(grouping.intra_axes))
    p_max = torch.full_like(b, f32(rcfg.p_max_watts))
    beta, p2_obj = waterfill_beta(rho, theta, p_max, b, rcfg.c1, rcfg.c0,
                                  reducer=wf_reducer)
    powers = power_from_beta(beta, rho, theta, p_max)

    # 4. power constraint (7) under the sampled channel
    powers = constraint7_powers(powers, streams.channel(t), rcfg.p_max_watts,
                                w_norm2)

    # 5+6. AirComp superposition + AWGN + normalization (sweep 2 of 2, or
    # the partial, one all-reduce and the finish) and the zero-uploader
    # guarded update
    held = carry.held
    if not grouped:
        agg, varsigma = paota_aggregate_stacked(payload, powers, b,
                                                streams.noise(t),
                                                reducer=reducer, tp=tp)
        new_global, new_prev = guarded_global_update(
            carry.global_vec, carry.prev_global, agg, varsigma,
            delta=rcfg.transmit_delta)
    elif sync:
        # held is the same on the intra_shards ranks of a pod, so 1 /
        # intra_shards of it under the all-client sum adds each pod's once;
        # at N = 1 held is 0 and the sum is the flat path's
        partial = paota_partial_stacked(payload, powers, b)
        scale = f32(1.0 / grouping.intra_shards)
        agg, varsigma = paota_finalize_stacked(partial + held * scale,
                                               payload, streams.noise(t),
                                               reducer=reducer)
        new_global, new_prev = guarded_global_update(
            carry.global_vec, carry.prev_global, agg, varsigma,
            delta=rcfg.transmit_delta)
        held = torch.zeros_like(held)
    else:
        partial = paota_partial_stacked(
            payload, powers, b, reducer=reducer.over(grouping.intra_axes))
        age = torch.tensor(float(rcfg.group_period - 1 - window_j))
        weight = float(staleness_factor(age, rcfg.omega))
        held = held + weight * partial
        varsigma = torch.zeros((), dtype=torch.float32, device=b.device)
        new_global, new_prev = carry.global_vec, carry.prev_global

    # 6b. divergence rollback, before the broadcast: a rolled-back round
    # retrains from the restored model (a non-sync period holds the global)
    good, good_n2, rolled = carry.good_global, carry.good_norm2, None
    if rcfg.divergence_factor > 0.0:
        if sync:
            new_global, new_prev, good, good_n2, rolled = \
                _divergence_rollback(new_global, new_prev, carry, rcfg)
        else:
            rolled = torch.zeros((), dtype=torch.float32, device=b.device)

    # 7. broadcast w^{r+1} to the restarters (the uploaders, and the
    # dropped uploaders whose update was lost), who restart local
    # training; their delta rows are refreshed as f32 trained - w_g^{r+1}
    # before the storage cast (with TP: this rank's block of both)
    t_next = t + 1
    n_ready, n_lat, n_model = sched_broadcast(
        ready, carry.busy_lat, carry.model_round, restart,
        streams.latencies(t_next), t_next)
    trained = streams.local_train(new_global, t_next)
    g_rows = new_global
    if tp is not None:
        trained, g_rows = tp_block(trained, tp, 1), tp_block(new_global,
                                                             tp, 0)
    pending, deltas = _refresh_rows(carry, restart, trained, g_rows)
    nxt = RoundCarry(t=t_next, time=time, ready=n_ready, busy_lat=n_lat,
                     model_round=n_model, global_vec=new_global,
                     prev_global=new_prev, pending=pending, deltas=deltas,
                     good_global=good, good_norm2=good_n2, held=held)
    out = _metrics(b, stal, beta, varsigma, p2_obj, n_screened, rolled,
                   reducer)
    if not sync:
        out["p2_objective"] = _pod_mean_objective(b, p2_obj, out, reducer,
                                                  grouping)
    return nxt, out


def _pod_mean_objective(b, p2_obj, out, reducer, grouping):
    """A non-sync period's P2 objective: the water level is per pod, so
    the mean over the pods that had uploaders (inf when none had)."""
    pod_upl = b.sum()
    intra = reducer.over(grouping.intra_axes)
    if intra is not None:
        pod_upl = intra.sum(pod_upl.reshape(1), tag="metrics_pod")[0]
    has = pod_upl > 0
    pods = reducer.over(grouping.pod_axes)
    pair = torch.stack([torch.where(has, p2_obj, torch.zeros_like(p2_obj)),
                        has.float()])
    if pods is not None:
        pair = pods.sum(pair, tag="metrics_pod")
    return torch.where(out["n_participants"] > 0,
                       pair[0] / torch.clamp_min(pair[1], 1.0),
                       torch.full_like(p2_obj, float("inf")))


def _refresh_rows(carry: RoundCarry, take, trained, new_global):
    """The payload rows under ``take`` get the freshly trained models:
    pending (when carried) and the delta trained - w_g^{r+1}, formed in
    f32 from the f32 trained rows and then cast to the planes' storage
    dtype (never a difference of two rounded models)."""
    def sel(new, old):
        return torch.where(take.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    pending = None if carry.pending is None else tree_map(
        lambda tr, p: sel(tr.to(p.dtype), p), trained, carry.pending)
    return pending, tree_map(lambda tr, dl, g: sel((tr - g).to(dl.dtype), dl),
                             trained, carry.deltas, new_global)


def _cohort_round_step(carry: RoundCarry, *, rcfg: RoundCfg,
                       streams: RoundStreams):
    """Active-cohort form of the round: the (K,) state plane advances as
    in the dense round, and the per-row stages (stats, P2, (7), AirComp)
    run over the m slot rows. Slot turnover: departing occupants
    (uploaded, or upload dropped) free their slots, and available idle
    clients fill them in priority order (a stable descending sort, ties to
    the lower id, as ``lax.top_k``); departed-but-unscheduled clients go
    idle at ``busy_lat = +inf``. With compression the stats and AirComp
    run on the (m, s) plane, and the EF residuals are handed off through
    the (K, s) parked plane: park, then resume, then consume. Stage for
    stage ``repro.fl.runtime._cohort_round_step``."""
    t = carry.t
    time = _round_time(t, rcfg.delta_t)
    k = carry.ready.shape[0]
    occ, live = carry.slot_client, carry.slot_live
    m = occ.shape[0]
    occ_l = occ.long()
    dev = occ.device

    # 1. (K,) state plane + scenario masks, gathered to the slots
    ready, stal_k = sched_advance(carry.ready, carry.busy_lat,
                                  carry.model_round, t, rcfg.delta_t)
    upl_k, depart_k, avail = _upload_masks(ready, streams, t)
    if avail is None:
        avail = torch.ones((k,), dtype=torch.bool, device=dev)
    b = (live & upl_k[occ_l]).to(torch.float32)
    stal = torch.where(live, stal_k[occ_l],
                       torch.zeros_like(occ)).to(torch.float32)

    # 2-4. stats (compressed: on the (m, s) plane; the identity support
    # and the uncompressed cohort: the dense stats), P2, (7)
    payload = carry.deltas if rcfg.transmit_delta else carry.pending
    d_model = carry.global_vec.shape[0] if rcfg.compress else 0
    identity = bool(rcfg.compress) and rcfg.compress_s >= d_model
    if rcfg.compress:
        v_id = (carry.deltas if carry.slot_scale is None
                else dequantize_int8(carry.deltas, carry.slot_scale))
        if identity:
            rho, theta, w_norm2 = round_factors(
                v_id, None, carry.global_vec, carry.prev_global, stal,
                rcfg.omega)
        else:
            rho, theta, w_norm2 = compressed_round_factors(
                carry.deltas, carry.slot_idx, carry.slot_resid,
                carry.slot_resid_idx, carry.global_vec, carry.prev_global,
                stal, rcfg.omega, scale=carry.slot_scale)
    else:
        rho, theta, w_norm2 = round_factors(
            carry.deltas, None if rcfg.transmit_delta else carry.pending,
            carry.global_vec, carry.prev_global, stal, rcfg.omega)

    # 2b. screening over the slots; compressed slots zero their value rows
    # and their int8 scales, so a NaN scale adds 0 * 0, never 0 * NaN
    n_screened = None
    vals_s, scale_s = carry.deltas, carry.slot_scale
    if rcfg.screen:
        payload, theta, w_norm2, b, ok, n_screened = _screen(
            None if rcfg.compress else payload, theta, w_norm2, b, rcfg)
        if rcfg.compress:
            vals_s = _zero_rows(vals_s, ok)
            if scale_s is not None:
                scale_s = torch.where(ok, scale_s, torch.zeros_like(scale_s))
            v_id = _zero_rows(v_id, ok)
    p_max = torch.full((m,), f32(rcfg.p_max_watts), device=dev)
    beta, p2_obj = waterfill_beta(rho, theta, p_max, b, rcfg.c1, rcfg.c0)
    powers = power_from_beta(beta, rho, theta, p_max)
    h = torch.where(live, streams.channel(t)[occ_l],
                    torch.zeros((m,), device=dev))
    powers = constraint7_powers(powers, h, rcfg.p_max_watts, w_norm2)

    # 5+6. AirComp over the slot rows (compressed: gather_superpose) and
    # the zero-uploader-guarded update
    if rcfg.compress and not identity:
        agg, varsigma = paota_aggregate_compressed(
            vals_s, carry.slot_idx, powers, b, streams.noise(t),
            d_model, scale=scale_s)
    else:
        agg, varsigma = paota_aggregate_stacked(
            v_id if rcfg.compress else payload, powers, b, streams.noise(t))
    new_global, new_prev = guarded_global_update(
        carry.global_vec, carry.prev_global, agg, varsigma,
        delta=rcfg.transmit_delta)

    # 6b. divergence rollback, before the slots refill and train
    good, good_n2, rolled = carry.good_global, carry.good_norm2, None
    if rcfg.divergence_factor > 0.0:
        new_global, new_prev, good, good_n2, rolled = _divergence_rollback(
            new_global, new_prev, carry, rcfg)

    # 7a. slot turnover: the highest-priority available idle clients fill
    # the freed slots, in slot order
    depart = live & depart_k[occ_l]
    stay = live & ~depart
    in_flight = _scatter_any(k, occ, stay)
    score = torch.where(avail & ~in_flight, streams.sched_priority(t),
                        torch.full((k,), float("-inf"), device=dev))
    top = torch.sort(score, descending=True, stable=True)
    top_score, top_ids = top.values[:m], top.indices[:m]
    n_cand = (top_score > float("-inf")).sum()
    free = ~stay
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    take = free & (free_rank < n_cand)
    pick = top_ids[free_rank.clamp(0, m - 1)].to(torch.int32)
    new_occ = torch.where(take, pick, occ)
    new_live = stay | take

    # 7b. (K,) bookkeeping: departed-but-unscheduled clients go idle,
    # scheduled ones get the broadcast
    sched_k = _scatter_any(k, new_occ, take)
    t_next = t + 1
    idle = _scatter_any(k, occ, depart) & ~sched_k
    ready = ready & ~idle
    busy = torch.where(idle, torch.full_like(carry.busy_lat, float("inf")),
                       carry.busy_lat)
    n_ready, n_lat, n_model = sched_broadcast(
        ready, busy, carry.model_round, sched_k, streams.latencies(t_next),
        t_next)

    # EF hand-off: park every departing slot's residual on its client's
    # row, then the scheduled occupants resume their parked rows (a
    # same-round depart -> reschedule resumes what it just parked), then
    # the consumed rows zero
    resid_val = resid_idx = pr_val = pr_idx = None
    if rcfg.compress and rcfg.error_feedback:
        resid_val = _set_rows(carry.resid_val, occ, carry.slot_resid, depart)
        resid_idx = _set_rows(carry.resid_idx, occ, carry.slot_resid_idx,
                              depart)
        new_l = new_occ.long()
        pr_val = torch.where(take[:, None], resid_val[new_l],
                             torch.zeros((), device=dev))
        if rcfg.screen:
            # a screened slot's parked residual may be the corrupt row's
            # NaN complement: resuming it would poison the client again
            pr_val = torch.where(torch.isfinite(pr_val), pr_val,
                                 torch.zeros((), device=dev))
        pr_idx = resid_idx[new_l]
        resid_val = _set_rows(resid_val, new_occ,
                              torch.zeros_like(carry.slot_resid), take)

    # 7c. cohort training: only the m slot rows; the newly scheduled slots
    # take their rows, retained slots keep their payload, dead slots keep
    # masked garbage
    trained = streams.cohort_train(new_global, t_next, new_occ)
    nxt = RoundCarry(t=t_next, time=time, ready=n_ready, busy_lat=n_lat,
                     model_round=n_model, global_vec=new_global,
                     prev_global=new_prev, pending=None, deltas=carry.deltas,
                     slot_client=new_occ, slot_live=new_live,
                     resid_val=resid_val, resid_idx=resid_idx,
                     good_global=good, good_norm2=good_n2)
    if rcfg.compress:
        comp = trained - new_global[None]
        if pr_val is not None:
            comp = comp + scatter_rows(pr_val, pr_idx, d_model)
        stored, idx_new, scale_new, e_val, e_idx = _compress_plane(
            comp, rcfg=rcfg, streams=streams, t=t_next)
        rows = take[:, None]
        nxt.deltas = torch.where(rows, stored, carry.deltas)
        nxt.slot_idx = torch.where(rows, idx_new, carry.slot_idx)
        if scale_new is not None:
            nxt.slot_scale = torch.where(take, scale_new, carry.slot_scale)
        if e_val is not None:
            nxt.slot_resid = torch.where(rows, e_val, carry.slot_resid)
            nxt.slot_resid_idx = torch.where(rows, e_idx,
                                             carry.slot_resid_idx)
    else:
        nxt.pending, nxt.deltas = _refresh_rows(carry, take, trained,
                                                new_global)
    return nxt, _metrics(b, stal, beta, varsigma, p2_obj, n_screened,
                         rolled)


def _init_planes(vec, trained, keep_pending: bool, rcfg):
    """(pending, deltas, good_global, good_norm2) of a round-0 carry: the
    f32 delta trained - w_g^0 formed before the storage cast, and the
    rollback slot seeded from w_g^0 when the detector is on."""
    dtype = _storage_dtype(rcfg)
    pending = _cast_rows(trained, dtype) if keep_pending else None
    deltas = tree_map(lambda tr, g: (tr - g).to(dtype), trained, vec)
    if rcfg is None or rcfg.divergence_factor <= 0.0:
        return pending, deltas, None, None
    return pending, deltas, vec, global_sq_norm(vec)


def init_round_carry(vec, *, streams: RoundStreams,
                     keep_pending: bool = True,
                     rcfg: Optional[RoundCfg] = None) -> RoundCarry:
    """Round-0 kick-off: broadcast w_g^0 to every client and run their
    local training. ``keep_pending=False`` (transmit='delta') carries the
    delta plane only; ``rcfg`` (its storage dtype and rollback knob)
    shapes the planes."""
    trained = streams.local_train(vec, 0)
    k = tree_leaves(trained)[0].shape[0]
    dev = tree_leaves(vec)[0].device
    pending, deltas, good, good_n2 = _init_planes(vec, trained,
                                                  keep_pending, rcfg)
    return RoundCarry(
        t=0, time=0.0,
        ready=torch.zeros((k,), dtype=torch.bool, device=dev),
        busy_lat=streams.latencies(0),
        model_round=torch.zeros((k,), dtype=torch.int32, device=dev),
        global_vec=vec, prev_global=vec, pending=pending, deltas=deltas,
        good_global=good, good_norm2=good_n2)


def init_cohort_carry(vec, *, streams: RoundStreams, k: int, m: int,
                      keep_pending: bool = True,
                      rcfg: Optional[RoundCfg] = None) -> RoundCarry:
    """Round-0 kick-off of the active-cohort carry: clients 0..m-1 fill the
    slots and get the broadcast; everyone else idles at busy_lat = +inf
    until a slot frees. With ``rcfg.compress`` the round-0 deltas go
    through the same ``_compress_plane`` the rounds use, with empty (K, s)
    parked-residual planes when error feedback is on."""
    if not 1 <= m <= k:
        raise ValueError(f"cohort_size={m} must lie in [1, K={k}]")
    dev = tree_leaves(vec)[0].device
    occ = torch.arange(m, dtype=torch.int32, device=dev)
    live = torch.ones((m,), dtype=torch.bool, device=dev)
    lat = streams.latencies(0)
    busy = torch.full_like(lat, float("inf"))
    busy[:m] = lat[:m]
    trained = streams.cohort_train(vec, 0, occ)
    compress = rcfg is not None and bool(rcfg.compress)
    pending, deltas, good, good_n2 = _init_planes(
        vec, trained, keep_pending and not compress, rcfg)
    carry = RoundCarry(
        t=0, time=0.0,
        ready=torch.zeros((k,), dtype=torch.bool, device=dev),
        busy_lat=busy,
        model_round=torch.zeros((k,), dtype=torch.int32, device=dev),
        global_vec=vec, prev_global=vec, pending=pending, deltas=deltas,
        slot_client=occ, slot_live=live, good_global=good,
        good_norm2=good_n2)
    if not compress:
        return carry
    stored, idx, scale, e_val, e_idx = _compress_plane(
        trained - vec[None], rcfg=rcfg, streams=streams, t=0)
    s = stored.shape[1]
    carry.pending, carry.deltas = None, stored
    carry.slot_idx, carry.slot_scale = idx, scale
    carry.slot_resid, carry.slot_resid_idx = e_val, e_idx
    if rcfg.error_feedback:
        carry.resid_val = torch.zeros((k, s), dtype=torch.float32,
                                      device=dev)
        carry.resid_idx = torch.zeros((k, s), dtype=torch.int32, device=dev)
    return carry


def scan_rounds(carry: RoundCarry, n_rounds: int, *, rcfg: RoundCfg,
                streams: RoundStreams, reducer=None, tp=None):
    """``n_rounds`` periods in a Python loop. Returns (carry, metrics):
    ``metrics`` maps each of ``DEVICE_METRICS`` (and of ``FAULT_METRICS``
    whose branch is on) to an (n_rounds,) device tensor, plus ``"time"``
    to a host list. ``reducer`` and ``tp``: the sharded round's."""
    return _stack_rounds(carry, [dict(window_j=0)] * n_rounds, rcfg=rcfg,
                         streams=streams, reducer=reducer, tp=tp)


def scan_windows(carry: RoundCarry, n_windows: int, *, rcfg: RoundCfg,
                 streams: RoundStreams, reducer, grouping: GroupTopology):
    """Grouped aggregation: ``n_windows`` windows of ``rcfg.group_period``
    periods, each period with its place in the window, so a window holds
    exactly one cross-pod model-sized all-reduce (at its sync). Returns
    (carry, metrics) on the flat (n_windows * N,) timeline, as
    ``scan_rounds``."""
    steps = [dict(window_j=j, grouping=grouping)
             for _ in range(n_windows) for j in range(rcfg.group_period)]
    return _stack_rounds(carry, steps, rcfg=rcfg, streams=streams,
                         reducer=reducer, tp=None)


def _stack_rounds(carry, steps, *, rcfg, streams, reducer, tp):
    outs = {}
    times = []
    for kw in steps:
        carry, out = paota_round_step(carry, rcfg=rcfg, streams=streams,
                                      reducer=reducer, tp=tp, **kw)
        for k, v in out.items():
            outs.setdefault(k, []).append(v)
        times.append(carry.time)
    stacked = {k: torch.stack(v) for k, v in outs.items()}
    stacked["time"] = times
    return carry, stacked
