"""Fused PAOTA server, torch form: R aggregation periods per ``advance``.

Port of ``repro.fl.fused.FusedPAOTA`` with every single-device knob of
the reference, in both transmit modes: the raveled or the params-dict
carry (``params_mode``), f32 or bf16 plane storage (``pending_dtype``),
the dense carry or the active cohort (``cohort_size``), the scenario
simulator (``scenario``), compressed cohort payloads (``compress``,
``compress_ratio``, ``slot_dtype``, ``error_feedback``), fault injection
(``faults``; pod blackouts run on ``repro_torch.fl.ShardedPAOTA`` with
grouped aggregation), screening (``screen``, ``screen_max_norm``),
divergence rollback (``divergence_factor``) and checkpoints
(``checkpoint_every``, ``checkpoint_dir``, ``save_checkpoint`` /
``restore_checkpoint``, in the reference's file format). Every stage of a
round runs on the device (``repro_torch.fl.runtime.paota_round_step``),
the delta-plane sweeps and the compressed AirComp through the
hand-written CUDA kernels on a GPU. The per-round metrics are copied to
the host once per ``advance``, as the reference's scan outputs are.

Randomness comes from a draw source (``repro_torch.fl.runtime``): by
default ``CounterDraws`` keyed on ``sched_cfg.seed`` (latencies) and
``cfg.seed`` (channel, noise, minibatch plans), the roles the reference's
seeds play; ``draws=ArrayDraws(...)`` replays given draws instead.
``cfg.rng`` and ``sched_cfg.rng`` are read by the host-path server only, as
in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.aggregation import ravel, tree_map
from repro_torch.core.aircomp import ChannelConfig
from repro_torch.core.power_control import p2_constants
from repro_torch.core.scheduler import (FaultConfig, ScenarioConfig,
                                        SchedulerConfig, fault_channel_mask,
                                        fault_payload_masks,
                                        inject_payload_faults)
from repro_torch.device import f32, full_f32_matmul, resolve_device
from repro_torch.fl.engine import BatchedEngine
from repro_torch.fl.runtime import (DEVICE_METRICS, FAULT_METRICS,
                                    CounterDraws, RoundCarry, RoundCfg,
                                    RoundStreams, init_cohort_carry,
                                    init_round_carry, scan_rounds)
from repro_torch.fl.server import PAOTAConfig

__all__ = ["FusedPAOTA"]


class FusedPAOTA:
    """PAOTA server whose rounds run entirely on the device.

    Same constructor shape as the reference's; ``clients`` is a list of
    ``repro_torch.fl.client.FLClient`` or a ``BatchedEngine``. ``device``
    defaults to ``"cuda"`` and raises without a GPU.

    ``params_mode="pytree"`` carries the model as its params dict, one
    contiguous (K, ...) tensor per leaf, so the sweeps run once per leaf;
    ``"raveled"`` (the default) as one (d,) vector and (K, d) planes. The
    two consume the same draws and agree to the reduction order.
    ``pending_dtype="bfloat16"`` stores the (K, ...) planes in bf16.
    ``cohort_size=m`` keeps model-sized rows for at most m in-flight
    clients; ``scenario`` (a ``ScenarioConfig``) runs the client-state
    simulator, its static traits installed on the engine; ``compress=
    "topk"|"randmask"`` (cohort, transmit='delta', raveled) shrinks each
    slot to s = round(d * ``compress_ratio``) values on a per-slot
    support, stored as ``slot_dtype`` ("float32", "bfloat16" or "int8";
    default ``pending_dtype``), with error-feedback residuals unless
    ``error_feedback=False``.

    ``faults`` (a ``FaultConfig``) injects NaN/Inf and Byzantine payload
    rows and deep fades from the draws' fault uniforms (pod blackouts need
    the grouped sharded driver, ``ShardedPAOTA(group_period >= 1)``, and
    are refused here); ``screen`` masks non-finite uploads, and with
    ``screen_max_norm`` over-norm ones, out of the superposition;
    ``divergence_factor`` arms the rollback to the last good global;
    ``checkpoint_every=N`` with ``checkpoint_dir`` saves the carry every N
    rounds. The validation and its messages are the reference's."""

    def __init__(self, init_params, clients, chan: ChannelConfig,
                 sched_cfg: SchedulerConfig, cfg: PAOTAConfig, *,
                 device=None, draws=None, params_mode: str = "raveled",
                 pending_dtype: str = "float32",
                 cohort_size: int | None = None,
                 scenario: ScenarioConfig | None = None,
                 compress: str | None = None, compress_ratio: float = 1.0,
                 slot_dtype: str | None = None, error_feedback: bool = True,
                 faults: FaultConfig | None = None, screen: bool = False,
                 screen_max_norm: float = 0.0,
                 divergence_factor: float = 0.0, checkpoint_every: int = 0,
                 checkpoint_dir: str | None = None):
        self.device = resolve_device(device)
        full_f32_matmul()
        if params_mode not in ("raveled", "pytree"):
            raise ValueError(f"params_mode={params_mode!r} (expected "
                             "'raveled' or 'pytree')")
        if pending_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"pending_dtype={pending_dtype!r} (expected "
                             "'float32' or 'bfloat16')")
        self.params_mode = params_mode
        if cfg.use_kernel:
            raise ValueError("use_kernel routes through the host-path "
                             "server (repro_torch.fl.PAOTAServer); the "
                             "fused round is already one fused device path")
        if cfg.solver not in ("waterfill", "waterfill_jnp"):
            raise ValueError(f"FusedPAOTA solves P2 by water-filling only; "
                             f"solver={cfg.solver!r} needs the host-path "
                             f"server (repro_torch.fl.PAOTAServer)")
        if cfg.engine != "batched":
            raise NotImplementedError(f"engine={cfg.engine!r}: the port has "
                                      f"the batched engine only")
        if cfg.transmit not in ("model", "delta"):
            raise ValueError(f"transmit={cfg.transmit!r} (expected 'model' "
                             f"or 'delta')")
        engine, self.k, n_samples = self._federation(clients)
        self.engine = engine
        params = tree_map(lambda t: torch.as_tensor(
            t, dtype=torch.float32, device=self.device), init_params)
        self._init_vec, self.unravel = ravel(params)
        self._init_global = (params if params_mode == "pytree"
                             else self._init_vec)
        self.d = int(self._init_vec.numel())
        self.scenario = scenario
        self.cohort_size = int(cohort_size) if cohort_size else 0
        if self.cohort_size and not 1 <= self.cohort_size <= self.k:
            raise ValueError(f"cohort_size={self.cohort_size} must lie in "
                             f"[1, K={self.k}]")
        self.compress = compress or ""
        if self.compress not in ("", "topk", "randmask"):
            raise ValueError(f"compress={compress!r} (expected None, 'topk' "
                             "or 'randmask')")
        sd = slot_dtype or ""
        if sd not in ("", "float32", "bfloat16", "int8"):
            raise ValueError(f"slot_dtype={slot_dtype!r} (expected None, "
                             "'float32', 'bfloat16' or 'int8')")
        if sd and not self.compress:
            raise ValueError("slot_dtype is compressed-slot storage; pass "
                             "compress='topk' or 'randmask' (the dense "
                             "carry's storage knob is pending_dtype)")
        self.compress_s = 0
        if self.compress:
            if not self.cohort_size:
                raise ValueError("compress needs active-cohort mode: pass "
                                 "cohort_size=m — the compressed (m, s) "
                                 "plane IS the cohort slot payload")
            if cfg.transmit != "delta":
                raise ValueError("compress rides transmit='delta': "
                                 "sparsifying full model vectors w_k makes "
                                 "no sense — compression targets the small "
                                 "local-update deltas")
            if params_mode != "raveled":
                raise NotImplementedError(
                    "compress + params_mode='pytree' is not wired yet (the "
                    "compressed plane needs per-leaf supports); use "
                    "params_mode='raveled'")
            if not 0.0 < compress_ratio <= 1.0:
                raise ValueError(f"compress_ratio={compress_ratio} (expected "
                                 "0 < ratio <= 1, the kept fraction s/d)")
            self.compress_s = min(self.d,
                                  max(1, int(round(self.d * compress_ratio))))
        if faults is not None and not isinstance(faults, FaultConfig):
            raise ValueError(f"faults={faults!r} (expected a FaultConfig "
                             "or None)")
        self.faults = faults
        if faults is not None and faults.has_blackout:
            self._check_blackout(faults)
        if screen_max_norm < 0.0:
            raise ValueError(f"screen_max_norm={screen_max_norm} (expected "
                             ">= 0; 0 = finite-only screening)")
        if screen_max_norm > 0.0 and not screen:
            raise ValueError("screen_max_norm is the screening norm fence; "
                             "pass screen=True to enable it")
        if divergence_factor < 0.0:
            raise ValueError(f"divergence_factor={divergence_factor} "
                             "(expected >= 0; 0 = detector off)")
        self.checkpoint_every = int(checkpoint_every or 0)
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every={checkpoint_every} "
                             "(expected >= 0; 0 = no periodic snapshots)")
        if self.checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every without checkpoint_dir: pass "
                             "the directory the periodic snapshots go to")
        self.checkpoint_dir = checkpoint_dir
        c1, c0 = p2_constants(cfg.smooth_l, cfg.eps_bound, self.k, self.d,
                              chan.sigma_n2)
        self._rcfg = RoundCfg(omega=cfg.omega, c1=c1, c0=c0,
                              p_max_watts=chan.p_max_watts,
                              delta_t=sched_cfg.delta_t,
                              transmit_delta=cfg.transmit == "delta",
                              cohort_size=self.cohort_size,
                              compress=self.compress,
                              compress_s=self.compress_s,
                              slot_dtype=((sd or pending_dtype)
                                          if self.compress else ""),
                              error_feedback=bool(error_feedback
                                                  and self.compress),
                              pending_dtype=pending_dtype,
                              screen=bool(screen),
                              screen_max_norm=float(screen_max_norm),
                              divergence_factor=float(divergence_factor))
        if draws is None:
            draws = CounterDraws(
                sched_cfg.seed, cfg.seed, self.device, k=self.k, d=self.d,
                lat_lo=sched_cfg.lat_lo, lat_hi=sched_cfg.lat_hi, chan=chan,
                n_samples=n_samples, local_steps=engine.local_steps,
                batch_size=engine.batch_size, scenario=scenario,
                m=self.cohort_size, s=self.compress_s)
        elif draws.device != self.device:
            raise ValueError(f"draws on {draws.device}, FusedPAOTA on "
                             f"{self.device}")
        self.draws = draws
        self._draws_local = self._local_draws(draws)
        # a noiseless channel skips the AWGN draw, as the reference does
        # for a static sigma_n = 0
        self._noiseless = chan.sigma_n == 0.0
        if scenario is not None and (scenario.het_steps or
                                     scenario.het_batch):
            # static per-client traits, drawn once and installed on the
            # engine (the batch fold itself is in the draws' batch plans)
            traits = self._draws_local.traits
            if traits is None:
                raise ValueError("a scenario with het_steps / het_batch "
                                 "needs draws that carry the static traits")
            engine.set_heterogeneity(traits.steps_k, traits.batch_k)
        self._streams = self._make_streams()
        self._carry: RoundCarry | None = None
        self.history: List[dict] = []

    def _federation(self, clients):
        """(engine, K, (K,) sample counts) of ``clients``: a list of
        ``FLClient`` or a ``BatchedEngine`` on this driver's device."""
        if isinstance(clients, BatchedEngine):
            engine = clients
            if engine.device != self.device:
                raise ValueError(f"engine on {engine.device}, FusedPAOTA on "
                                 f"{self.device}")
        else:
            engine = BatchedEngine.from_clients(list(clients),
                                                device=self.device)
        return engine, engine.n_clients, engine.n_samples

    def _check_blackout(self, faults: FaultConfig) -> None:
        raise NotImplementedError(
            f"pod_blackout={faults.pod_blackout} needs the grouped "
            f"sharded driver (pods are a mesh topology): the nearest "
            f"supported configuration is repro_torch.fl.ShardedPAOTA with "
            f"group_period >= 1 and pod_axes covering "
            f"{len(faults.pod_blackout)}+ pods")

    def _local_draws(self, draws):
        """The draws this driver's rows consume: all of them."""
        return draws

    def _make_streams(self) -> RoundStreams:
        """The round's callbacks. A draw the configuration does not use
        stays None, as in the reference: the scenario masks only when the
        scenario can mask, the cohort's training and priorities only in
        cohort mode, the randmask support only below s = d, the dither
        only for int8 slots; the fault wrappers exist only while their
        fraction is above 0."""
        draws, engine, rcfg = self._draws_local, self.engine, self._rcfg
        sc = self.scenario
        cohort = rcfg.cohort_size > 0
        if self.params_mode == "pytree":
            def local_train(g, r):
                return engine.train_all_tree(g, draws.batch_plan(r))

            def cohort_train(g, r, ids):
                return engine.train_rows_tree(
                    g, draws.batch_plan(r)[ids.long()], ids)
        else:
            def local_train(g, r):
                return engine.train_all(self.unravel(g), draws.batch_plan(r))

            def cohort_train(g, r, ids):
                return engine.train_rows(
                    self.unravel(g), draws.batch_plan(r)[ids.long()], ids)
        channel = draws.channel
        fc = self.faults
        if fc is not None and fc.has_payload_faults:
            local_train = self._faulty_local_train(local_train)
            cohort_train = self._faulty_cohort_train(cohort_train)
        if fc is not None and fc.has_channel_faults:
            channel = self._faulty_channel(channel)
        return RoundStreams(
            local_train=local_train,
            latencies=draws.latencies, channel=channel,
            noise=(lambda t: None) if self._noiseless else draws.noise,
            scenario=(draws.scenario_masks
                      if sc is not None and sc.has_masks else None),
            cohort_train=cohort_train if cohort else None,
            sched_priority=draws.sched_priority if cohort else None,
            compress_mask=(draws.compress_mask
                           if rcfg.compress == "randmask"
                           and rcfg.compress_s < self.d else None),
            quant_uniform=(draws.quant_uniform
                           if rcfg.slot_dtype == "int8" else None))

    def _faulty_local_train(self, train):
        """``train`` with the round's payload faults injected into the
        trained rows, what a broken client's uplink would carry."""
        draws, fc = self._draws_local, self.faults

        def faulty(g, r):
            nm, bm = fault_payload_masks(draws.fault_uniform(r), r, fc)
            return inject_payload_faults(train(g, r), g, nm, bm, fc)
        return faulty

    def _faulty_cohort_train(self, train):
        """The cohort's twin: the masks are drawn for all K clients and
        gathered by the slots' global client ids, so a client suffers the
        same fault in a slot as in a dense row."""
        draws, fc = self._draws_local, self.faults

        def faulty(g, r, ids):
            nm, bm = fault_payload_masks(draws.fault_uniform(r), r, fc)
            sel = ids.long()
            return inject_payload_faults(train(g, r, ids), g, nm[sel],
                                         bm[sel], fc)
        return faulty

    def _faulty_channel(self, channel):
        """The channel draws with the deep fades applied: a faded client's
        |h_k| is scaled by ``deep_fade_gain``, and cap (7) then drives its
        power toward zero."""
        draws, fc = self._draws_local, self.faults

        def faulty(t):
            h = channel(t)
            fade = fault_channel_mask(draws.fade_uniform(t), t, fc)
            return torch.where(fade, h * f32(fc.deep_fade_gain), h)
        return faulty

    @property
    def global_vec(self):
        """w_g^t as a numpy (d,) vector, in the reference's ravel order
        (a params-dict global is raveled on demand)."""
        g = self._init_global if self._carry is None else self._carry.global_vec
        if self.params_mode == "pytree":
            g = ravel(g)[0]
        return g.detach().cpu().numpy()

    def global_params(self):
        """w_g^t as a params dict on the device (views of the vector in
        raveled mode)."""
        g = self._init_global if self._carry is None else self._carry.global_vec
        return g if self.params_mode == "pytree" else self.unravel(g)

    def _cohort_extents(self):
        """(client rows, slots, real rows) of this driver's cohort carry:
        the whole federation here."""
        return self.k, self.cohort_size, None

    def _ensure_carry(self) -> RoundCarry:
        # transmit='delta' never reads the full local models: the carry is
        # the delta plane alone
        if self._carry is None:
            keep = not self._rcfg.transmit_delta
            with torch.no_grad():
                if self.cohort_size:
                    k, m, n_real = self._cohort_extents()
                    self._carry = init_cohort_carry(
                        self._init_global, streams=self._streams, k=k, m=m,
                        n_real=n_real, keep_pending=keep, rcfg=self._rcfg)
                else:
                    self._carry = init_round_carry(
                        self._init_global, streams=self._streams,
                        keep_pending=keep, rcfg=self._rcfg)
        return self._carry

    # checkpoint / resume: every draw is keyed on the carry's own round,
    # so a restored carry draws what the uninterrupted run drew

    def _carry_record(self, carry: RoundCarry) -> RoundCarry:
        """The carry as the reference stores it: the round counter as an
        i32 and the clock as an f32 scalar."""
        return dataclasses.replace(
            carry, t=torch.tensor(carry.t, dtype=torch.int32),
            time=torch.tensor(carry.time, dtype=torch.float32))

    def save_checkpoint(self, path: str):
        """Save the whole round carry (globals, planes, cohort slots,
        compressed residuals, the rollback slot) and the history in the
        reference's format (``repro_torch.checkpoint.io``), which either
        package restores. Builds the round-0 carry first if the driver
        has not advanced yet."""
        carry = self._carry_record(self._ensure_carry())
        ckpt_io.save_checkpoint(path, carry, step=len(self.history),
                                extra={"history": self.history})

    def restore_checkpoint(self, path: str) -> int:
        """Rebind the driver to a checkpoint: the planes restore bit for
        bit against this driver's own carry layout (a layout or dtype
        mismatch raises), the history replaces this driver's, and the
        next ``advance`` continues the saved run. Returns its step."""
        template = self._carry_record(self._ensure_carry())
        rec, step, extra = ckpt_io.load_checkpoint(path, template)
        on_dev = {f.name: tree_map(lambda x: x.to(self.device),
                                   getattr(rec, f.name))
                  for f in dataclasses.fields(rec)
                  if getattr(rec, f.name) is not None}
        on_dev["t"] = int(rec.t)
        on_dev["time"] = float(rec.time)
        self._carry = dataclasses.replace(rec, **on_dev)
        self.history = list(extra.get("history", []))
        return step

    def _checkpoint_path(self, round_idx: int) -> str:
        return os.path.join(self.checkpoint_dir, f"round_{round_idx:06d}.npz")

    def advance(self, n_rounds: int) -> List[dict]:
        """Run ``n_rounds`` rounds; appends and returns the per-round
        history dicts (one device-to-host copy per uninterrupted stretch).
        With ``checkpoint_every=N`` the rounds split at every N-round
        boundary and the carry is saved there, which leaves the
        trajectory as it is."""
        every = self.checkpoint_every
        if not every:
            return self._advance(n_rounds)
        rows: List[dict] = []
        done = 0
        while done < n_rounds:
            step = min(every - len(self.history) % every, n_rounds - done)
            rows.extend(self._advance(step))
            done += step
            if len(self.history) % every == 0:
                self.save_checkpoint(self._checkpoint_path(len(self.history)))
        return rows

    def _advance(self, n_rounds: int) -> List[dict]:
        if n_rounds < 1:
            return []
        with torch.no_grad():
            carry = self._ensure_carry()
            self._carry, outs = scan_rounds(carry, n_rounds, rcfg=self._rcfg,
                                            streams=self._streams)
        return self._history_rows(outs, n_rounds)

    def _history_rows(self, outs, n_rounds: int) -> List[dict]:
        """The per-round history dicts of a stretch's metrics (one
        device-to-host copy), appended to ``history``."""
        names = DEVICE_METRICS + tuple(k for k in FAULT_METRICS if k in outs)
        host = torch.stack([outs[k] for k in names]).cpu().numpy()
        base = len(self.history)
        rows = []
        for i in range(n_rounds):
            row = {"round": base + i, "time": outs["time"][i]}
            row.update({k: float(host[j, i]) for j, k in enumerate(names)})
            row["n_participants"] = int(row["n_participants"])
            # a branch left off screens nothing and never rolls back
            for k in FAULT_METRICS:
                row.setdefault(k, 0.0)
            rows.append(row)
        self.history.extend(rows)
        return rows

    def round(self) -> dict:
        """One round (drop-in for the host server's ``round``)."""
        return self.advance(1)[-1]
