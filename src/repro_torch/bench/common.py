"""Shared harness of the paper-reproduction benchmarks (Fig. 3/4, Table I).

The port's ``benchmarks/common.py``. Builds the federation once (synthetic
MNIST-like, non-IID partition per Section IV-A) and runs PAOTA / Local SGD
/ COTAF servers on the device, recording (round, simulated time, train
loss, test accuracy) trajectories.

``BenchSetting`` carries the reference's fields. ``engine="sharded"``
(``ShardedPAOTA``, with ``group_period`` and ``tp``, and the fused
round's knobs: the cohort, compression, faults and checkpoints) runs
once a process group is up, e.g. under ``python -m
torch.distributed.run``; without one it is refused with that command.
The ``legacy`` engine is refused by name.
Beside the reference's fields it keeps the port's ``transmit`` (unset:
"delta" under ``compress``, "model" otherwise) and ``slot_dtype``.
Artifacts go to ``out_dir()``: ``$REPRO_BENCH_OUT``, by default
``experiments/bench_torch``, so the reference's CPU artifacts under
``experiments/bench/`` are never overwritten.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ChannelConfig, SchedulerConfig
from repro_torch.core.scheduler import FaultConfig
from repro_torch.data.partition import partition_noniid
from repro_torch.data.pipeline import build_federation
from repro_torch.data.synthetic import get_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import (COTAFServer, FLClient, FusedPAOTA, LocalSGDServer,
                            PAOTAConfig, PAOTAServer, ShardedPAOTA,
                            SyncConfig, evaluate)
from repro_torch.models.mlp import init_mlp_params, mlp_apply, mlp_loss

DEFAULT_OUT_DIR = "experiments/bench_torch"
ENGINES = ("batched", "fused", "sharded")
NOT_PORTED_ENGINES = ("legacy",)
# how the sharded engine is started: one process a rank
SHARDED_COMMAND = ("python -m torch.distributed.run --nproc-per-node N -m "
                   "repro_torch.launch.fl_train --engine sharded "
                   "--dist-backend nccl|gloo ...")


def out_dir() -> str:
    """Where artifacts, trajectory CSVs and checkpoints go."""
    return os.environ.get("REPRO_BENCH_OUT", DEFAULT_OUT_DIR)


def nvidia_smi_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def write_bench_artifact(name: str, rows: List[Dict],
                         extra: Optional[Dict] = None, device=None) -> str:
    """Persist one benchmark's rows as ``<out_dir()>/BENCH_<name>.json``,
    with what makes two runs comparable: the backend the rows ran on
    (``"cuda"`` / ``"cpu"``), the device count, the torch and CUDA
    versions, the card's name and power limit (``nvidia-smi``), and the
    REPRO_BENCH_* environment. Returns the artifact path."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    path = os.path.join(out_dir(), f"BENCH_{name}.json")
    os.makedirs(out_dir(), exist_ok=True)
    payload = {
        "name": name,
        "created_unix": time.time(),
        "backend": dev.type,
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": nvidia_smi_line() if cuda else None,
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "env": {k: v for k, v in os.environ.items()
                if k.startswith("REPRO_BENCH")},
        "rows": rows,
    }
    if extra:
        payload["config"] = extra
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return path


@dataclass
class BenchSetting:
    n_clients: int = 40          # paper: 100 (REPRO_BENCH_FULL=1 restores
    n_rounds: int = 60           # 100 clients, 120 rounds, 50 selected)
    n_select: int = 20           # sync baselines' participants per round
    lr: float = 0.1
    local_steps: int = 5         # M
    batch_size: int = 32
    delta_t: float = 8.0
    n0_dbm_hz: float = -174.0
    eval_every: int = 2
    seed: int = 0
    solver: str = "waterfill"
    engine: str = "batched"      # batched: host-path PAOTAServer; fused:
                                 # FusedPAOTA; sharded: ShardedPAOTA over
                                 # the process group (baselines batched)
    params_mode: str = "raveled"   # fused / sharded: raveled | pytree
    pending_dtype: str = "float32"  # fused / sharded: (K, ...) storage
    group_period: int = 0        # sharded: grouped aggregation window N
    cohort_size: int = 0         # fused / sharded: m in-flight slots
    compress: str = ""           # cohort: "" | topk | randmask;
                                 # switches transmit to "delta"
    compress_ratio: float = 1.0  # kept fraction s/d
    error_feedback: bool = True  # compress: per-client EF residuals
    tp: int = 1                  # sharded + pytree: intra-client TP extent
    faults: str = ""             # fused / sharded: parse_faults spec
    screen: bool = False         # fused / sharded: screen the uploads
    screen_max_norm: float = 0.0  # screening norm fence (0: finite-only)
    divergence_factor: float = 0.0  # rollback detector (0: off)
    checkpoint_every: int = 0    # fused / sharded: snapshot every N
    checkpoint_dir: str = ""     # default <out_dir()>/checkpoints
    resume: str = ""             # fused / sharded: file to restore first
    transmit: str = ""           # PAOTA payload: "" (delta under compress,
                                 # else model) | model | delta
    slot_dtype: str = ""         # compressed slot storage: "" | float32 |
                                 # bfloat16 | int8

    def __post_init__(self):
        if self.engine in NOT_PORTED_ENGINES:
            raise NotImplementedError(
                f"engine={self.engine!r} selects a reference engine the port "
                f"does not have; the ported engines are {ENGINES}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine={self.engine!r} (expected one of "
                             f"{ENGINES})")
        if self.engine == "sharded" and not dist.is_initialized():
            raise NotImplementedError(
                f"engine='sharded' runs the round over a process group, "
                f"and none is up: start one process a rank, e.g. "
                f"{SHARDED_COMMAND}")
        if self.group_period and self.engine != "sharded":
            raise NotImplementedError(
                f"group_period={self.group_period}: grouped aggregation "
                f"runs on engine='sharded' (--engine sharded)")
        if self.tp != 1 and self.engine != "sharded":
            raise NotImplementedError(
                f"tp={self.tp}: intra-client tensor parallelism runs on "
                f"engine='sharded' (--engine sharded)")
        if self.engine == "batched" and (
                self.cohort_size or self.compress or self.slot_dtype
                or self.params_mode != "raveled"
                or self.pending_dtype != "float32" or self.fault_tolerant):
            raise ValueError(
                "params_mode, pending_dtype, cohort_size, compress, "
                "slot_dtype and the fault and checkpoint knobs are options "
                "of the fused and sharded rounds: pass engine='fused' "
                "(--engine fused) or engine='sharded'")

    @classmethod
    def from_env(cls, **kw):
        s = cls(**kw)
        if os.environ.get("REPRO_BENCH_FULL") == "1":
            s.n_clients, s.n_rounds, s.n_select = 100, 120, 50
        return s

    @property
    def paota_transmit(self) -> str:
        """PAOTA's payload: the explicit ``transmit``, else "delta" under
        ``compress`` (compression targets the small update, as the
        reference's ``run_algorithm`` switches it) and "model" otherwise."""
        return self.transmit or ("delta" if self.compress else "model")

    @property
    def fault_tolerant(self) -> bool:
        """Any fault-tolerance knob set: these sweeps are PAOTA-only."""
        return bool(self.faults or self.screen or self.divergence_factor
                    or self.checkpoint_every or self.resume)


# fault-spec keys -> FaultConfig fields ("inf" flips nan_mode, not a field)
_FAULT_KEYS = {"nan": ("nan_frac", float), "inf": ("nan_frac", float),
               "byz": ("byzantine_frac", float),
               "scale": ("byzantine_scale", float),
               "fade": ("deep_fade_frac", float),
               "gain": ("deep_fade_gain", float),
               "start": ("start", int), "stop": ("stop", int),
               "pods": ("pod_blackout", None),
               "bstart": ("blackout_start", int),
               "bstop": ("blackout_stop", int)}


def parse_faults(spec: str):
    """CLI fault spec -> ``FaultConfig``: comma-separated ``kind:value``
    pairs — ``nan:0.05`` (NaN payload fraction; ``inf:`` for +Inf rows),
    ``byz:0.1`` / ``scale:-50`` (Byzantine fraction / delta scale),
    ``fade:0.02`` / ``gain:1e-4`` (deep-fade fraction / gain),
    ``start:`` / ``stop:`` (active round window), ``pods:0|2`` /
    ``bstart:`` / ``bstop:`` (pod-blackout indices and window, which
    ``FusedPAOTA`` refuses by name). Empty/None spec -> None."""
    if not spec:
        return None
    kw = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, val = part.partition(":")
        if kind not in _FAULT_KEYS:
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r} "
                             f"(expected one of {sorted(_FAULT_KEYS)})")
        field, cast = _FAULT_KEYS[kind]
        if kind == "pods":
            kw[field] = tuple(int(p) for p in val.split("|") if p)
        else:
            kw[field] = cast(val)
        if kind == "inf":
            kw["nan_mode"] = "inf"
    return FaultConfig(**kw)


def build_world(s: BenchSetting):
    """(clients, init params, (x_tr, y_tr, x_te, y_te)) of the federation;
    the params are made on the CPU and copied to each server's device."""
    x_tr, y_tr, x_te, y_te = get_dataset(
        n_train=max(200 * s.n_clients, 4000), n_test=2000)
    parts = partition_noniid(y_tr, n_clients=s.n_clients, seed=s.seed)
    fed = build_federation(x_tr, y_tr, parts, seed=s.seed)
    clients = [FLClient(d, mlp_loss, batch_size=s.batch_size, lr=s.lr,
                        local_steps=s.local_steps) for d in fed]
    return clients, init_mlp_params(s.seed), (x_tr, y_tr, x_te, y_te)


def train_loss(params, x, y, n: int = 4096) -> float:
    """The training loss on a fixed subset of n samples."""
    sel = np.random.default_rng(0).choice(len(y), size=min(n, len(y)),
                                          replace=False)
    dev = params["l1"]["w"].device
    with torch.no_grad():
        return float(mlp_loss(params, {
            "x": torch.as_tensor(x[sel], device=dev),
            "y": torch.as_tensor(y[sel], device=dev).long()}))


def make_server(name: str, s: BenchSetting, clients, params,
                seed_offset: int = 0, *, device=None, draws=None):
    """The algorithm's server on ``device``. ``draws`` replaces PAOTA's
    and COTAF's default draw source (tests replay the reference's)."""
    dev = resolve_device(device)
    chan = ChannelConfig(n0_dbm_hz=s.n0_dbm_hz)
    sched = SchedulerConfig(n_clients=s.n_clients, delta_t=s.delta_t,
                            seed=s.seed + seed_offset)
    if s.fault_tolerant and name != "paota":
        return None             # fault-tolerance sweeps are PAOTA-only
    if name == "paota":
        cfg = PAOTAConfig(solver=s.solver, seed=s.seed,
                          transmit=s.paota_transmit)
        if s.engine == "batched":
            return PAOTAServer(params, clients, chan, sched, cfg,
                               device=dev, draws=draws)
        kw = dict(draws=draws, params_mode=s.params_mode,
                  pending_dtype=s.pending_dtype, cohort_size=s.cohort_size,
                  compress=s.compress or None,
                  compress_ratio=s.compress_ratio,
                  slot_dtype=s.slot_dtype or None,
                  error_feedback=s.error_feedback, screen=s.screen,
                  screen_max_norm=s.screen_max_norm,
                  divergence_factor=s.divergence_factor)
        if s.faults:
            kw["faults"] = parse_faults(s.faults)
        if s.checkpoint_every:
            kw.update(checkpoint_every=s.checkpoint_every,
                      checkpoint_dir=s.checkpoint_dir
                      or os.path.join(out_dir(), "checkpoints"))
        if s.engine == "sharded":
            srv = ShardedPAOTA(params, clients, chan, sched, cfg,
                               mesh=sharded_mesh(s), device=dev,
                               group_period=s.group_period, **kw)
        else:
            srv = FusedPAOTA(params, clients, chan, sched, cfg, device=dev,
                             **kw)
        if s.resume:
            done = srv.restore_checkpoint(s.resume)
            print(f"resumed {name} from {s.resume} (round {done})")
        return srv
    sync = SyncConfig(n_select=s.n_select, seed=s.seed)
    if name == "local_sgd":
        return LocalSGDServer(params, clients, sched, sync, device=dev)
    if name == "cotaf":
        return COTAFServer(params, clients, sched, sync, chan, device=dev,
                           draws=draws)
    raise ValueError(name)


def sharded_mesh(s: BenchSetting):
    """The sharded engine's mesh over the process group: every rank a
    client shard, or with ``tp > 1`` a ("pod", "data", "tp") mesh of one
    pod whose data axis takes world / tp ranks (the reference's)."""
    from repro_torch.launch.mesh import make_client_mesh, make_pod_mesh
    if s.tp > 1:
        world = dist.get_world_size()
        if world % s.tp:
            raise ValueError(f"tp={s.tp} does not divide the {world} ranks")
        return make_pod_mesh(pods=1, data=world // s.tp, tp=s.tp)
    return make_client_mesh()


def run_algorithm(name: str, s: BenchSetting, clients, params, data,
                  seed_offset: int = 0, *, device=None,
                  draws=None) -> List[Dict]:
    """``s.n_rounds`` rounds of one algorithm; returns the evaluated rows
    (every ``s.eval_every`` rounds and the last). With a fault-tolerance
    knob set the baselines return no rows."""
    x_tr, y_tr, x_te, y_te = data
    dev = resolve_device(device)
    srv = make_server(name, s, clients, params, seed_offset, device=dev,
                      draws=draws)
    if srv is None:
        return []
    rows = []
    t0 = time.time()
    # grouped aggregation advances whole windows: drain a window's rows
    window = s.group_period if (name == "paota" and s.engine == "sharded"
                                and s.group_period > 1) else 0
    pending: List[Dict] = []
    for r in range(s.n_rounds):
        if window:
            if not pending:
                pending = list(srv.advance(window))
            info = pending.pop(0)
        else:
            info = srv.round()
        if r % s.eval_every == 0 or r == s.n_rounds - 1:
            gp = srv.global_params()
            ev = evaluate(gp, x_te, y_te, mlp_apply)
            rows.append({
                "algo": name, "round": info["round"],
                "time": round(info["time"], 2),
                "loss": round(train_loss(gp, x_tr, y_tr), 4),
                "accuracy": round(ev["accuracy"], 4),
                "test_loss": round(ev["loss"], 4),
                "wall_s": round(time.time() - t0, 1),
            })
    return rows
