"""The paper's experiment driver on one GPU (Section IV): PAOTA against the
Local SGD and COTAF baselines on the non-IID synthetic MNIST federation.

    PYTHONPATH=src python -m repro_torch.launch.fl_train --rounds 200 \\
        --clients 40 [--engine batched|fused] [--solver waterfill] \\
        [--n0 -174] [--transmit model] [--device cuda|cpu] [--out PATH]

The port's counterpart of ``examples/fl_noniid_mnist.py`` with
``benchmarks.common.build_world`` / ``run_algorithm``: the same
``BenchSetting`` defaults (``REPRO_BENCH_FULL=1`` restores the paper's 100
clients, 120 rounds and 50 synchronous participants), the same dataset
(``get_dataset(n_train=max(200 K, 4000), n_test=2000)``), partition seed and
one federation shared by the three algorithms, whose minibatch cursors
carry from one to the next as the reference's do. It runs ``paota``,
``local_sgd`` and ``cotaf`` in turn, evaluates every ``eval_every`` rounds,
prints the Table-I summary (round and simulated time to each target
accuracy) and writes the trajectory CSV with the reference's columns.

``--engine batched`` (default) runs PAOTA on the host-path
``PAOTAServer``; ``--engine fused`` runs the fused on-device round
(``FusedPAOTA``, counter draws), with the baselines on the batched engine
as the reference does. The reference's ``legacy`` and ``sharded`` engines
are not ported and are refused by name, and so is its ``--group-period``
(grouped aggregation needs the sharded engine).

With ``--engine fused``, ``--params-mode pytree`` carries the model as its
params dict (one contiguous tensor per leaf, the sweeps launched per
leaf) instead of the raveled (K, d) plane, and ``--pending-dtype
bfloat16`` stores the (K, ...) planes in bf16 (f32 accumulation, f32
globals). ``--cohort-size m`` runs the active-cohort round
(model rows only for the m in-flight slots), and ``--compress
topk|randmask`` with ``--compress-ratio s/d`` sparsifies the slot payloads
to (m, s) planes with per-client error-feedback residuals
(``--no-error-feedback`` drops them), stored as ``--slot-dtype
float32|bfloat16|int8`` and superposed by the ``gather_superpose`` kernel
(compression rides ``--transmit delta``).
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import ChannelConfig, SchedulerConfig
from repro_torch.data.partition import partition_noniid
from repro_torch.data.pipeline import build_federation
from repro_torch.data.synthetic import get_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import (COTAFServer, FLClient, FusedPAOTA, LocalSGDServer,
                            PAOTAConfig, PAOTAServer, SyncConfig, evaluate,
                            time_to_accuracy, write_csv)
from repro_torch.models.mlp import (init_mlp_params, mlp_apply, mlp_loss)

ALGORITHMS = ("paota", "local_sgd", "cotaf")
ENGINES = ("batched", "fused")
NOT_PORTED_ENGINES = ("legacy", "sharded")


@dataclass
class BenchSetting:
    n_clients: int = 40          # paper: 100 (REPRO_BENCH_FULL=1)
    n_rounds: int = 60
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
                                 # FusedPAOTA (baselines stay batched)
    transmit: str = "model"      # PAOTA payload: "model" | "delta"
    cohort_size: int = 0         # fused PAOTA: m in-flight slots (0: dense)
    compress: str = ""           # fused cohort payloads: "" | topk | randmask
    compress_ratio: float = 1.0  # kept fraction s/d
    slot_dtype: str = ""         # "" (f32) | float32 | bfloat16 | int8
    error_feedback: bool = True
    params_mode: str = "raveled"   # fused PAOTA: raveled | pytree carry
    pending_dtype: str = "float32"  # fused PAOTA: plane storage

    @classmethod
    def from_env(cls, **kw):
        s = cls(**kw)
        if os.environ.get("REPRO_BENCH_FULL") == "1":
            s.n_clients, s.n_rounds, s.n_select = 100, 120, 50
        return s


def build_world(s: BenchSetting):
    """(clients, init params, (x_tr, y_tr, x_te, y_te)) of the federation."""
    data = get_dataset(n_train=max(200 * s.n_clients, 4000), n_test=2000)
    x_tr, y_tr = data[0], data[1]
    parts = partition_noniid(y_tr, n_clients=s.n_clients, seed=s.seed)
    fed = build_federation(x_tr, y_tr, parts, seed=s.seed)
    clients = [FLClient(d, mlp_loss, batch_size=s.batch_size, lr=s.lr,
                        local_steps=s.local_steps) for d in fed]
    return clients, init_mlp_params(s.seed), data


def train_loss(params, x, y, n: int = 4096) -> float:
    """The training loss on a fixed subset of n samples."""
    sel = np.random.default_rng(0).choice(len(y), size=min(n, len(y)),
                                          replace=False)
    dev = params["l1"]["w"].device
    with torch.no_grad():
        return float(mlp_loss(params, {
            "x": torch.as_tensor(x[sel], device=dev),
            "y": torch.as_tensor(y[sel], device=dev).long()}))


def make_server(name: str, s: BenchSetting, clients, params, device):
    chan = ChannelConfig(n0_dbm_hz=s.n0_dbm_hz)
    sched = SchedulerConfig(n_clients=s.n_clients, delta_t=s.delta_t,
                            seed=s.seed)
    if name == "paota":
        cfg = PAOTAConfig(solver=s.solver, seed=s.seed,
                          transmit=s.transmit)
        if s.engine == "fused":
            return FusedPAOTA(params, clients, chan, sched, cfg,
                              device=device, cohort_size=s.cohort_size,
                              compress=s.compress or None,
                              compress_ratio=s.compress_ratio,
                              slot_dtype=s.slot_dtype or None,
                              error_feedback=s.error_feedback,
                              params_mode=s.params_mode,
                              pending_dtype=s.pending_dtype)
        return PAOTAServer(params, clients, chan, sched, cfg, device=device)
    sync = SyncConfig(n_select=s.n_select, seed=s.seed)
    if name == "local_sgd":
        return LocalSGDServer(params, clients, sched, sync, device=device)
    if name == "cotaf":
        return COTAFServer(params, clients, sched, sync, chan, device=device)
    raise ValueError(name)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_algorithm(name: str, s: BenchSetting, clients, params, data,
                  device) -> List[Dict]:
    """``s.n_rounds`` rounds of one algorithm; returns the evaluated rows
    (every ``s.eval_every`` rounds and the last)."""
    x_tr, y_tr, x_te, y_te = data
    dev = resolve_device(device)
    srv = make_server(name, s, clients, params, dev)
    rows = []
    t0 = time.time()
    for r in range(s.n_rounds):
        info = srv.round()
        if r % s.eval_every == 0 or r == s.n_rounds - 1:
            _sync(dev)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--n0", type=float, default=-174.0)
    ap.add_argument("--solver", default="waterfill",
                    choices=["waterfill", "pgd", "milp"])
    ap.add_argument("--engine", default="batched",
                    choices=ENGINES + NOT_PORTED_ENGINES,
                    help="batched = host-path PAOTAServer; fused = the "
                         "whole PAOTA round on the device (counter draws; "
                         "baselines stay batched)")
    ap.add_argument("--transmit", default="model", choices=["model", "delta"])
    ap.add_argument("--params-mode", default="raveled",
                    choices=["raveled", "pytree"],
                    help="fused: model carry, the raveled (K, d) plane or "
                         "the params dict (sweeps per leaf)")
    ap.add_argument("--pending-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="fused: storage of the (K, ...) planes (f32 "
                         "accumulation, f32 globals)")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="fused: active-cohort round with m slots")
    ap.add_argument("--compress", default="", choices=["", "topk",
                                                       "randmask"],
                    help="fused cohort: compressed slot payloads")
    ap.add_argument("--compress-ratio", type=float, default=1.0,
                    help="kept fraction s/d of each compressed row")
    ap.add_argument("--slot-dtype", default="",
                    choices=["", "float32", "bfloat16", "int8"],
                    help="storage of the compressed slot values")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="drop the compressed slots' EF residuals")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="fl_noniid_torch.csv")
    args = ap.parse_args(argv)
    if args.engine in NOT_PORTED_ENGINES:
        raise NotImplementedError(
            f"--engine {args.engine} selects a reference engine the port "
            f"does not have; the ported engines are {ENGINES}")
    if args.engine != "fused" and (
            args.cohort_size or args.compress or args.slot_dtype
            or args.params_mode != "raveled"
            or args.pending_dtype != "float32"):
        raise ValueError("--params-mode, --pending-dtype, --cohort-size, "
                         "--compress and --slot-dtype are options of the "
                         "fused round: pass --engine fused")
    dev = resolve_device(args.device)

    s = BenchSetting.from_env(n_rounds=args.rounds, n_clients=args.clients,
                              n0_dbm_hz=args.n0, solver=args.solver,
                              engine=args.engine, transmit=args.transmit,
                              cohort_size=args.cohort_size,
                              compress=args.compress,
                              compress_ratio=args.compress_ratio,
                              slot_dtype=args.slot_dtype,
                              error_feedback=not args.no_error_feedback,
                              params_mode=args.params_mode,
                              pending_dtype=args.pending_dtype)
    clients, params, data = build_world(s)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"PAOTA vs Local SGD vs COTAF on {dev} ({name}): "
          f"K={s.n_clients}, rounds={s.n_rounds}, engine={s.engine}, "
          f"transmit={s.transmit}"
          + (f", params={s.params_mode}, pending={s.pending_dtype}"
             if s.engine == "fused" else "")
          + (f", cohort={s.cohort_size}, compress={s.compress or 'none'}"
             if s.cohort_size else ""))
    all_rows = []
    for algo in ALGORITHMS:
        rows = run_algorithm(algo, s, clients, params, data, dev)
        all_rows.extend(rows)
        for r in rows:
            print(f"{algo:>9} {r['round']:>5} {r['time']:>9.2f} "
                  f"{r['accuracy']:>7.4f} {r['loss']:>8.4f}")
        tta = time_to_accuracy(rows)
        print(f"\n=== {algo} === final acc {rows[-1]['accuracy']:.3f} "
              f"@ sim {rows[-1]['time']:.0f}s")
        for tgt, (rnd, tm) in tta.items():
            print(f"  target {tgt:.0%}: round={rnd} time={tm}")
    write_csv(args.out, all_rows)
    print(f"\ntrajectories -> {args.out}")


if __name__ == "__main__":
    main()
