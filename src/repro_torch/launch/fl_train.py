"""The paper's experiment driver on one GPU (Section IV): PAOTA against the
Local SGD and COTAF baselines on the non-IID synthetic MNIST federation.

    PYTHONPATH=src python -m repro_torch.launch.fl_train --rounds 200 \\
        --clients 40 [--engine batched|fused] [--solver waterfill] \\
        [--n0 -174] [--device cuda|cpu] [--out PATH]

The port's counterpart of ``examples/fl_noniid_mnist.py``, on the port's
harness (``repro_torch.bench.common``: ``BenchSetting``, ``build_world``,
``run_algorithm``): ``REPRO_BENCH_FULL=1`` restores the paper's 100
clients, 120 rounds and 50 synchronous participants, and one federation
is shared by the three algorithms, whose minibatch cursors carry from one
to the next as the reference's do. It runs ``paota``, ``local_sgd`` and
``cotaf`` in turn, evaluates every ``eval_every`` rounds, prints the
Table-I summary (round and simulated time to each target accuracy) and
writes the trajectory CSV with the reference's columns.

``--engine batched`` (default) runs PAOTA on the host-path
``PAOTAServer``; ``--engine fused`` runs the fused on-device round
(``FusedPAOTA``, counter draws), with the baselines on the batched engine
as the reference does. ``--engine sharded`` runs PAOTA's round over the
ranks of a process group (``ShardedPAOTA``), one process a rank:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.fl_train --engine sharded \
        --dist-backend gloo --device cuda:0 [--group-period N] \
        [--tp T --params-mode pytree]

``--dist-backend nccl`` with ``--device cuda`` gives each rank
``cuda:LOCAL_RANK``; ranks that share one card need gloo. Rank 0 runs the
baselines, prints and writes the CSV. The reference's ``legacy`` engine
is not ported and is refused by name.

The fused round's knobs need ``--engine fused``: ``--params-mode
pytree`` (the params dict carry, the sweeps launched per leaf),
``--pending-dtype bfloat16`` (bf16 planes, f32 accumulation),
``--cohort-size m`` (model rows only for the m in-flight slots),
``--compress topk|randmask`` with ``--compress-ratio s/d`` (default
1/16: (m, s) slot payloads with error-feedback residuals unless
``--no-error-feedback``, stored as ``--slot-dtype``; compression switches
PAOTA's payload to ``delta``, and an explicit ``--transmit model`` with it
is refused), and the fault-tolerance flags ``--faults``, ``--screen``,
``--screen-max-norm``, ``--divergence-factor``, ``--checkpoint-every``,
``--checkpoint-dir`` and ``--resume``, with which only PAOTA runs (the
baselines write no rows), as in the reference.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.bench.common import (ENGINES, NOT_PORTED_ENGINES,
                                      BenchSetting, build_world,
                                      run_algorithm)
from repro_torch.device import resolve_device
from repro_torch.fl import time_to_accuracy, write_csv

ALGORITHMS = ("paota", "local_sgd", "cotaf")


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
    ap.add_argument("--transmit", default="", choices=["", "model", "delta"],
                    help="PAOTA payload (unset: delta under --compress, "
                         "model otherwise)")
    ap.add_argument("--params-mode", default="raveled",
                    choices=["raveled", "pytree"],
                    help="fused: model carry, the raveled (K, d) plane or "
                         "the params dict (sweeps per leaf)")
    ap.add_argument("--pending-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="fused: storage of the (K, ...) planes (f32 "
                         "accumulation, f32 globals)")
    ap.add_argument("--group-period", type=int, default=0,
                    help="sharded: grouped aggregation, N periods a window")
    ap.add_argument("--tp", type=int, default=1,
                    help="sharded + --params-mode pytree: intra-client TP "
                         "extent")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="sharded: the process group's backend (gloo for "
                         "ranks that share one card, and on the CPU)")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="fused: active-cohort round with m slots")
    ap.add_argument("--compress", default="", choices=["", "topk",
                                                       "randmask"],
                    help="fused cohort: compressed slot payloads; switches "
                         "PAOTA's payload to delta")
    ap.add_argument("--compress-ratio", type=float, default=1.0 / 16.0,
                    help="s/d for --compress (default 1/16)")
    ap.add_argument("--slot-dtype", default="",
                    choices=["", "float32", "bfloat16", "int8"],
                    help="storage of the compressed slot values")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="drop the compressed slots' EF residuals")
    ap.add_argument("--faults", default="",
                    help="fused PAOTA only: fault-injection spec, comma-"
                         "separated kind:value pairs — nan:F / inf:F "
                         "(NaN/+Inf payload fraction), byz:F + scale:S "
                         "(Byzantine deltas), fade:F + gain:G (deep-fade "
                         "channel outliers), start:R / stop:R (active "
                         "window); pods:0|2 + bstart:R + bstop:R (pod "
                         "blackout) needs --engine sharded with "
                         "--group-period. E.g. 'nan:0.05,start:1'")
    ap.add_argument("--screen", action="store_true",
                    help="mask non-finite uploads out of the AirComp "
                         "superposition")
    ap.add_argument("--screen-max-norm", type=float, default=0.0,
                    help="with --screen: also screen rows with payload "
                         "norm beyond this fence (0 = finite-only)")
    ap.add_argument("--divergence-factor", type=float, default=0.0,
                    help="roll the global back to the last-good slot when "
                         "a post-update norm jump exceeds this factor "
                         "(0 = detector off)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="fused PAOTA: snapshot the full round carry every "
                         "N rounds (0 = off)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="where --checkpoint-every snapshots go (default "
                         "<bench out dir>/checkpoints)")
    ap.add_argument("--resume", default="",
                    help="checkpoint path to restore before training: the "
                         "resumed PAOTA run continues the saved one bit "
                         "for bit, then runs --rounds more rounds")
    ap.add_argument("--device", default="cuda",
                    help="cuda, cuda:N or cpu (sharded with cuda: "
                         "cuda:LOCAL_RANK)")
    ap.add_argument("--out", default="fl_noniid_torch.csv")
    args = ap.parse_args(argv)
    rank = 0
    if args.engine == "sharded" and "WORLD_SIZE" in os.environ:
        if not dist.is_initialized():
            dist.init_process_group(backend=args.dist_backend,
                                    init_method="env://")
        rank = dist.get_rank()
        if args.device == "cuda":
            args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    s = BenchSetting.from_env(n_rounds=args.rounds, n_clients=args.clients,
                              n0_dbm_hz=args.n0, solver=args.solver,
                              engine=args.engine, transmit=args.transmit,
                              params_mode=args.params_mode,
                              pending_dtype=args.pending_dtype,
                              group_period=args.group_period, tp=args.tp,
                              cohort_size=args.cohort_size,
                              compress=args.compress,
                              compress_ratio=args.compress_ratio,
                              slot_dtype=args.slot_dtype,
                              error_feedback=not args.no_error_feedback,
                              faults=args.faults, screen=args.screen,
                              screen_max_norm=args.screen_max_norm,
                              divergence_factor=args.divergence_factor,
                              checkpoint_every=args.checkpoint_every,
                              checkpoint_dir=args.checkpoint_dir,
                              resume=args.resume)
    dev = resolve_device(args.device)
    clients, params, data = build_world(s)
    say = print if rank == 0 else (lambda *a, **k: None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"PAOTA vs Local SGD vs COTAF on {dev} ({name}): "
        f"K={s.n_clients}, rounds={s.n_rounds}, engine={s.engine}, "
        f"transmit={s.paota_transmit}"
        + (f", params={s.params_mode}, pending={s.pending_dtype}"
           if s.engine != "batched" else "")
        + (f", cohort={s.cohort_size}, compress={s.compress or 'none'}"
           if s.cohort_size else ""))
    all_rows = []
    for algo in ALGORITHMS:
        if rank and algo != "paota":
            continue        # the baselines need no collective: rank 0's
        rows = run_algorithm(algo, s, clients, params, data, device=dev)
        if not rows:
            continue        # fault-tolerance sweeps skip the baselines
        all_rows.extend(rows)
        for r in rows:
            say(f"{algo:>9} {r['round']:>5} {r['time']:>9.2f} "
                f"{r['accuracy']:>7.4f} {r['loss']:>8.4f}")
        tta = time_to_accuracy(rows)
        say(f"\n=== {algo} === final acc {rows[-1]['accuracy']:.3f} "
            f"@ sim {rows[-1]['time']:.0f}s")
        for tgt, (rnd, tm) in tta.items():
            say(f"  target {tgt:.0%}: round={rnd} time={tm}")
    if rank == 0:
        write_csv(args.out, all_rows)
        say(f"\ntrajectories -> {args.out}")


if __name__ == "__main__":
    main()
