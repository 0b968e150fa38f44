"""Mesh-sharded PAOTA over ``torch.distributed``: the fused round with the
federation's client rows split over ranks.

Port of ``repro.fl.sharded.ShardedPAOTA``. ``FusedPAOTA`` runs a period on
one device; a federation of 10^4..10^5 clients then serializes through
one card. ``ShardedPAOTA`` lays the round's (K,) and (K, ...) client rows
and the federation's data over the client axes of a ``Mesh``
(``repro_torch.launch.mesh``): each rank builds its engine over its own
clients and runs the port's round loop (``repro_torch.fl.runtime``) on its
rows, with a ``Reducer`` where the reference calls ``psum``:

* local SGD, the scheduler state, the channel, the eq.-25 factors (sweep
  1, one launch a leaf) and the power cap (7) are per client: no
  collective;
* the superposition is ONE model-sized all-reduce a round: the flat
  (d_total + 1,) f32 partial (``ops.aircomp_partial``, one launch a leaf)
  with the varsigma partial appended; the noise joins once, after it,
  drawn at full shapes from the replicated round generator;
* the water-filling and the metrics use small packed all-reduces.

Draws: every rank holds the full-K draw source (``CounterDraws`` by
default) and takes its rows of each draw, padded first with the phantom
fill (``ShardDraws``); minibatch plans are keyed by global client id, so
a client trains alike on any rank. The noise is replicated. Every rank
ends each round with bit-identical globals, and the trajectory is
allclose to ``FusedPAOTA``'s round for round (the sum order across ranks
is the only difference).

Phantom clients pad K up to a multiple of the shard count: never ready
(busy_lat = +inf), channel 0 (so power 0) and one zero data row.

Grouped aggregation (``group_period`` N >= 1): the client axes split into
pod axes (``pod_axes``, default the first client axis) and intra-pod
axes. Each non-sync period a pod water-fills and superposes its own
clients (an intra-pod all-reduce) into the carry's ``held`` slot, weighted
by the staleness factor of its age at the sync; the window's sync sends
the one cross-pod model-sized all-reduce. ``advance`` moves in whole
windows; N = 1 is the flat program bit for bit. ``faults`` with a pod
blackout darkens whole pods (contiguous row blocks, the pod axes leading
the client axes) through the availability mask.

Intra-client TP (``tp_axes``, pytree mode; default the mesh's "tp" axis):
each stacked payload leaf keeps one trailing dim split over the TP ranks,
the one chosen by ``repro_torch.sharding.rules.stack_client_specs``, so
placement and slicing cannot disagree (``repro_torch.sharding.tp``).
Extent 1 is the flat program bit for bit.

Refused by name: the active cohort and compressed payloads under
sharding, and periodic checkpoints of a sharded carry.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from repro_torch.core.aircomp import ChannelConfig
from repro_torch.core.scheduler import (FaultConfig, ScenarioTraits,
                                        SchedulerConfig, blackout_active)
from repro_torch.data.pipeline import ClientData
from repro_torch.fl.engine import BatchedEngine
from repro_torch.fl.fused import FusedPAOTA
from repro_torch.fl.runtime import (GroupTopology, RoundStreams, scan_rounds,
                                    scan_windows)
from repro_torch.fl.server import PAOTAConfig
from repro_torch.launch.collectives import Reducer
from repro_torch.launch.mesh import data_axes
from repro_torch.sharding.rules import stack_client_specs
from repro_torch.sharding.tp import TPTopology, tp_block
from repro_torch.tree import build, leaves_with_paths, tree_leaves

__all__ = ["ShardedPAOTA", "ShardDraws"]

# a uniform no fault band reaches (the bands lie in [0, 1])
_NEVER_FAULTS = 2.0


class ShardDraws:
    """One rank's rows of a full-K draw source: each (K,) draw padded to
    K_pad with its phantom fill, then sliced at the rank's offset. The
    noise is the full draw, the same on every rank."""

    def __init__(self, full, offset: int, k_local: int, k: int):
        self.full = full
        self.device = full.device
        self.offset, self.k_local, self.k = offset, k_local, k
        traits = full.traits
        self.traits = None if traits is None else ScenarioTraits(
            *(self._rows(a, 1) for a in traits))

    def _rows(self, full_k, fill):
        """Rows [offset, offset + k_local) of ``full_k`` padded with
        ``fill`` past K (a shard that straddles the real rows and the
        phantoms must not clamp into real rows)."""
        lo, hi = self.offset, self.offset + self.k_local
        got = full_k[lo:min(hi, self.k)]
        if got.shape[0] == self.k_local:
            return got
        pad = torch.full((self.k_local - got.shape[0],) + full_k.shape[1:],
                         fill, dtype=full_k.dtype, device=full_k.device)
        return torch.cat([got, pad])

    def latencies(self, r: int):
        return self._rows(self.full.latencies(r), float("inf"))

    def channel(self, t: int):
        return self._rows(self.full.channel(t), 0.0)

    def noise(self, t: int):
        return self.full.noise(t)

    def batch_plan(self, r: int):
        return self._rows(self.full.batch_plan(r), 0)

    def scenario_masks(self, t: int):
        avail, drop = self.full.scenario_masks(t)
        return self._rows(avail, False), self._rows(drop, False)

    def fault_uniform(self, r: int):
        return self._rows(self.full.fault_uniform(r), _NEVER_FAULTS)

    def fade_uniform(self, t: int):
        return self._rows(self.full.fade_uniform(t), _NEVER_FAULTS)


def _phantom(like: ClientData) -> ClientData:
    """A phantom client's dataset: one zero row."""
    x = np.zeros((1,) + np.asarray(like.x).shape[1:],
                 np.asarray(like.x).dtype)
    return ClientData(x, np.zeros((1,), np.asarray(like.y).dtype), -1)


def _default_device(device):
    if device is not None:
        return device
    return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"


class ShardedPAOTA(FusedPAOTA):
    """Drop-in ``FusedPAOTA`` whose rows are split over ``mesh``'s client
    axes (``client_axes``, default its "pod" / "data" axes). ``clients``
    is the whole federation (a list of ``FLClient`` or a
    ``BatchedEngine``): each rank keeps its own rows. ``device`` defaults
    to ``cuda:LOCAL_RANK``. ``draws`` is a full-K draw source. See the
    module docstring for ``group_period`` / ``pod_axes`` and ``tp_axes``
    (with ``model_cfg`` for an architecture's placement)."""

    def __init__(self, init_params, clients, chan: ChannelConfig,
                 sched_cfg: SchedulerConfig, cfg: PAOTAConfig, *, mesh,
                 client_axes=None, params_mode: str = "raveled",
                 model_cfg=None, pending_dtype: str = "float32",
                 group_period: int = 0, pod_axes=None, tp_axes=None,
                 scenario=None, faults: FaultConfig | None = None,
                 screen: bool = False, screen_max_norm: float = 0.0,
                 divergence_factor: float = 0.0, device=None, draws=None,
                 cohort_size: int | None = None, compress: str | None = None,
                 checkpoint_every: int = 0):
        for name, value in (("cohort_size", cohort_size),
                            ("compress", compress),
                            ("checkpoint_every", checkpoint_every)):
            if value:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to the sharded round "
                    f"yet (ShardedPAOTA; the sharded cohort's slots are "
                    f"shard-local and its checkpoints sharded); the "
                    f"nearest supported configuration is FusedPAOTA with "
                    f"{name}={value!r}, or ShardedPAOTA without it")
        self.mesh = mesh
        axes = mesh.axes(client_axes) if client_axes else data_axes(mesh)
        if not axes:
            raise ValueError(f"mesh {mesh.axis_names} has no client axis")
        self.client_axes = axes
        self.n_shards = mesh.extent(axes)
        if tp_axes is None:
            tp_ax = tuple(a for a in mesh.axis_names
                          if a == "tp" and a not in axes)
        else:
            tp_ax = tuple(tp_axes)
            bad = [a for a in tp_ax
                   if a not in mesh.axis_names or a in axes]
            if bad:
                raise ValueError(
                    f"tp_axes={tp_ax}: {bad} must be non-client mesh axes "
                    f"(mesh axes {mesh.axis_names}, client_axes={axes})")
        self.tp_axes = tp_ax
        self.tp_shards = mesh.extent(tp_ax) if tp_ax else 1
        if self.tp_shards > 1:
            if len(tp_ax) > 1:
                raise NotImplementedError(
                    f"tp_axes={tp_ax}: intra-client TP splits a leaf dim "
                    f"over one mesh axis; the nearest supported "
                    f"configuration merges them into one 'tp' axis of "
                    f"extent {self.tp_shards}")
            if group_period:
                raise NotImplementedError(
                    f"group_period={group_period} does not compose with "
                    f"intra-client TP (tp axes {tp_ax}, extent "
                    f"{self.tp_shards}) yet: the held intra-pod partial "
                    f"has no TP split; the nearest supported "
                    f"configurations are group_period={group_period} with "
                    f"TP extent 1, or TP with group_period=0")
            if params_mode != "pytree":
                raise NotImplementedError(
                    f"params_mode='raveled' does not compose with "
                    f"intra-client TP (tp axes {tp_ax}, extent "
                    f"{self.tp_shards}): the flat (K, d) stack has no leaf "
                    f"dims to split; the nearest supported configurations "
                    f"are params_mode='pytree', or raveled on a "
                    f"client-axes-only mesh")
        other = {a: mesh.shape[a] for a in mesh.axis_names
                 if a not in axes and a not in tp_ax and mesh.shape[a] > 1}
        if other:
            named = ", ".join(f"'{a}' (extent {n})"
                              for a, n in sorted(other.items()))
            raise NotImplementedError(
                f"ShardedPAOTA shards the client axes and the tp_axes "
                f"only, but mesh axis {named} has extent > 1; name it in "
                f"tp_axes or client_axes, or rebuild the mesh with extent "
                f"1 on {sorted(other)}")
        if group_period < 0:
            raise ValueError(f"group_period={group_period} (expected >= 0)")
        if pod_axes is not None and not group_period:
            raise ValueError("pod_axes without group_period: pass "
                             "group_period=N >= 1 to enable grouped "
                             "aggregation")
        self._grouping = None
        self.n_pod_groups = 1
        if group_period:
            pods = tuple(pod_axes) if pod_axes else (axes[0],)
            bad = [a for a in pods if a not in axes]
            if bad or len(set(pods)) != len(pods):
                raise ValueError(f"pod_axes={pods} must be distinct client "
                                 f"axes (client_axes={axes})")
            intra = tuple(a for a in axes if a not in pods)
            self._grouping = GroupTopology(
                pod_axes=pods, intra_axes=intra,
                intra_shards=mesh.extent(intra) if intra else 1)
            self.n_pod_groups = mesh.extent(pods)
        self.group_period = int(group_period)
        self.reducer = Reducer(mesh, axes)
        self._model_cfg = model_cfg
        super().__init__(init_params, clients, chan, sched_cfg, cfg,
                         device=_default_device(device), draws=draws,
                         params_mode=params_mode,
                         pending_dtype=pending_dtype, scenario=scenario,
                         faults=faults, screen=screen,
                         screen_max_norm=screen_max_norm,
                         divergence_factor=divergence_factor)
        self._rcfg = self._rcfg._replace(group_period=self.group_period)
        self._tp = self._derive_tp() if self.tp_shards > 1 else None

    # -- the rank's federation ----------------------------------------
    def _federation(self, clients):
        """This rank's engine over its clients and phantoms; K and the
        sample counts of the whole federation."""
        if isinstance(clients, BatchedEngine):
            fed = list(clients.fed)
            loss_fn, hp = clients.loss_fn, (clients.batch_size, clients.lr,
                                            clients.local_steps)
        else:
            clients = list(clients)
            fed = [c.data for c in clients]
            c0 = clients[0]
            for c in clients[1:]:
                if (c.loss_fn is not c0.loss_fn
                        or (c.batch_size, c.lr, c.local_steps)
                        != (c0.batch_size, c0.lr, c0.local_steps)):
                    raise ValueError("ShardedPAOTA requires homogeneous "
                                     "client hyperparameters")
            loss_fn, hp = c0.loss_fn, (c0.batch_size, c0.lr, c0.local_steps)
        k = len(fed)
        self.k_pad = -(-k // self.n_shards) * self.n_shards
        self.n_phantom = self.k_pad - k
        self.k_local = self.k_pad // self.n_shards
        self.offset = self.mesh.index(self.client_axes) * self.k_local
        mine = fed[self.offset:self.offset + self.k_local]
        mine += [_phantom(fed[0])] * (self.k_local - len(mine))
        engine = BatchedEngine(mine, loss_fn, batch_size=hp[0], lr=hp[1],
                               local_steps=hp[2], device=self.device)
        n_samples = np.array([len(c) for c in fed], np.int64)
        return engine, k, n_samples

    def _check_blackout(self, faults: FaultConfig) -> None:
        """A pod blackout needs grouped pods that lead the client axes
        (each pod a contiguous block of rows)."""
        if self._grouping is None:
            raise NotImplementedError(
                f"pod_blackout={faults.pod_blackout} needs grouped "
                f"aggregation (pods are a mesh topology): the nearest "
                f"supported configuration is ShardedPAOTA with "
                f"group_period >= 1")
        pods = self._grouping.pod_axes
        if pods != self.client_axes[:len(pods)]:
            raise NotImplementedError(
                f"pod_blackout with pod_axes={pods}: the blackout's pod -> "
                f"client-row map needs the pod axes to lead the client "
                f"axes {self.client_axes}; the nearest supported "
                f"configuration reorders client_axes to put {pods} first")

    def _local_draws(self, draws):
        return ShardDraws(draws, self.offset, self.k_local, self.k)

    def _make_streams(self) -> RoundStreams:
        streams = super()._make_streams()
        fc = self.faults
        if fc is None or not fc.has_blackout:
            return streams
        rows_per_pod = self.k_pad // self.n_pod_groups
        rows = np.arange(self.offset, self.offset + self.k_local)
        dark = torch.as_tensor(np.isin(rows // rows_per_pod,
                                       [int(p) for p in fc.pod_blackout]),
                               device=self.device)
        base = streams.scenario

        def scenario(t):
            blk = dark if blackout_active(fc, t) else torch.zeros_like(dark)
            if base is None:
                return ~blk, torch.zeros_like(blk)
            avail, drop = base(t)
            return avail & ~blk, drop
        return streams._replace(scenario=scenario)

    # -- intra-client TP ----------------------------------------------
    def _derive_tp(self) -> TPTopology:
        """The TP split of each leaf, read off ``stack_client_specs`` of
        the stacked params: the (unstacked) trailing dim its spec gives
        the TP axis, -1 for a replicated leaf."""
        shapes = build([p for p, _ in leaves_with_paths(self._init_global)],
                       [_Shape((self.k_pad,) + tuple(l.shape))
                        for l in tree_leaves(self._init_global)])
        specs = stack_client_specs(shapes, self._model_cfg, self.mesh,
                                   self.client_axes,
                                   tp_axis=self.tp_axes[0])
        tp_set = set(self.tp_axes)
        dims = []
        for spec in tree_leaves(specs):     # per-dim tuples, leaf order
            dim = -1
            for i, entry in enumerate(spec):
                names = (entry if isinstance(entry, tuple)
                         else (entry,) if entry else ())
                if not any(a in tp_set for a in names):
                    continue
                if i == 0 or (set(names) - tp_set) or dim >= 0:
                    raise NotImplementedError(
                        f"unsupported TP placement {spec}: the TP "
                        f"axes {self.tp_axes} must occupy exactly one "
                        f"trailing leaf dim, alone")
                dim = i - 1
            dims.append(dim)
        return TPTopology(axes=self.tp_axes,
                          extents=tuple(self.mesh.shape[a]
                                        for a in self.tp_axes),
                          shards=self.tp_shards, leaf_dims=tuple(dims),
                          index=self.mesh.index(self.tp_axes))

    # -- the carry and the rounds --------------------------------------
    def _ensure_carry(self):
        if self._carry is not None:
            return self._carry
        carry = super()._ensure_carry()
        if self._tp is not None:
            carry.pending, carry.deltas = (
                None if tree is None else tp_block(tree, self._tp, 1)
                for tree in (carry.pending, carry.deltas))
        if self._grouping is not None:
            carry.held = torch.zeros((self.d + 1,), dtype=torch.float32,
                                     device=self.device)
        self._carry = carry
        return carry

    def _advance(self, n_rounds: int) -> List[dict]:
        if n_rounds < 1:
            return []
        n = self.group_period
        if self._grouping is not None and n_rounds % n:
            raise ValueError(
                f"grouped aggregation advances whole windows: n_rounds="
                f"{n_rounds} is not a multiple of group_period={n}")
        with torch.no_grad():
            carry = self._ensure_carry()
            if self._grouping is None:
                carry, outs = scan_rounds(carry, n_rounds, rcfg=self._rcfg,
                                          streams=self._streams,
                                          reducer=self.reducer, tp=self._tp)
            else:
                carry, outs = scan_windows(carry, n_rounds // n,
                                           rcfg=self._rcfg,
                                           streams=self._streams,
                                           reducer=self.reducer,
                                           grouping=self._grouping)
        self._carry = carry
        return self._history_rows(outs, n_rounds)

    def save_checkpoint(self, path: str):
        raise NotImplementedError(
            "checkpoints of a sharded carry are not ported yet (each rank "
            "holds its rows); the nearest supported configuration is "
            "FusedPAOTA.save_checkpoint")

    def restore_checkpoint(self, path: str) -> int:
        raise NotImplementedError(
            "checkpoints of a sharded carry are not ported yet (each rank "
            "holds its rows); the nearest supported configuration is "
            "FusedPAOTA.restore_checkpoint")


class _Shape:
    """A shape-only leaf for the placement rules."""

    def __init__(self, shape):
        self.shape = tuple(shape)
