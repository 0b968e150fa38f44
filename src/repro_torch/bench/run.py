"""Benchmark harness entry point — one module per paper table/figure.

    python -m repro_torch.bench.run [--device cuda|cpu] [modules ...]

The port's ``benchmarks/run.py``. Prints ``name,us_per_call,derived`` CSV
rows:
  bound       — Theorem-1 contraction + P2 gap terms
  kernels     — the delta-plane kernels at K x d = 100 x 8070 and the SWA
                kernel at (4, 512, 64), twin and hand-written kernel
  fl_engine   — batched federation engine and host-server rounds/sec
                (K up to 1000)
  fused_round — host-path vs fused on-device PAOTA rounds/sec (K up to
                1000)
  round_perf  — the canonical tracked delta-plane series: host/fused
                seconds/round at K in {16, 1000}, raveled + pytree, model
                + delta transmit (d = 55,050 MLP, 1 local step)
  fig3        — train-loss robustness vs noise (paper Fig. 3)
  fig4        — test accuracy vs rounds/time (paper Fig. 4)
  table1      — time/rounds to target accuracy (paper Table I)
  ablation    — solver, partitioner and transmit ablations

Each completed module also writes ``BENCH_<module>.json`` (the rows plus
backend, card and environment) under ``$REPRO_BENCH_OUT``, by default
``experiments/bench_torch``. The reference's ``roofline``,
``sharded_round``, ``grouped_round``, ``tp_round``, ``cohort_round`` and
``fault_round`` modules are not ported yet and are refused by name.

Env: REPRO_BENCH_FULL=1 for paper scale (100 clients, 120 rounds); the
default is the reference's scaled setting with identical structure. The
modules run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import importlib
import traceback

from repro_torch.bench.common import write_bench_artifact
from repro_torch.device import resolve_device

MODULES = ["bound", "kernels_bench", "fl_engine_bench", "fused_round_bench",
           "round_perf_bench", "fig3", "fig4", "table1", "ablation"]
NOT_PORTED = ("roofline_bench", "sharded_round_bench", "grouped_round_bench",
              "tp_round_bench", "cohort_round_bench", "fault_round_bench")
ALIASES = {"kernels": "kernels_bench", "roofline": "roofline_bench",
           "fl_engine": "fl_engine_bench", "engine": "fl_engine_bench",
           "fused_round": "fused_round_bench", "fused": "fused_round_bench",
           "round_perf": "round_perf_bench",
           "sharded_round": "sharded_round_bench",
           "sharded": "sharded_round_bench",
           "grouped_round": "grouped_round_bench",
           "grouped": "grouped_round_bench",
           "cohort_round": "cohort_round_bench",
           "cohort": "cohort_round_bench",
           "tp_round": "tp_round_bench", "tp": "tp_round_bench",
           "fault_round": "fault_round_bench", "fault": "fault_round_bench"}


def resolve_modules(names) -> list:
    """Module names for ``names`` (aliases resolved; all modules when
    empty); unported modules raise ``NotImplementedError`` by name and
    unknown ones ``ValueError``, before anything runs."""
    wanted = [ALIASES.get(w, w) for w in (names or MODULES)]
    for w in wanted:
        if w in NOT_PORTED:
            raise NotImplementedError(
                f"bench module {w!r} is not ported yet; the port runs "
                f"{MODULES}")
        if w not in MODULES:
            raise ValueError(f"unknown bench module {w!r}; available: "
                             f"{MODULES} (aliases {sorted(ALIASES)})")
    return wanted


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("modules", nargs="*")
    args = ap.parse_args(argv)
    wanted = resolve_modules(args.modules)
    dev = resolve_device(args.device)
    print("name,us_per_call,derived")
    failed = []
    for mod_name in wanted:
        try:
            mod = importlib.import_module(f"repro_torch.bench.{mod_name}")
            rows = list(mod.run(device=dev))
            for row in rows:
                print(f"{row['name']},{row['us_per_call']},{row['derived']}",
                      flush=True)
            # BENCH_<name> drops the module's `_bench` suffix, as the
            # modules' own entry points name their artifacts
            art = mod_name[:-6] if mod_name.endswith("_bench") else mod_name
            path = write_bench_artifact(art, rows, device=dev)
            print(f"# artifact -> {path}", flush=True)
        except Exception:
            traceback.print_exc()
            failed.append(mod_name)
    if failed:
        raise SystemExit(f"# FAILED: {failed}")
    return 0


if __name__ == "__main__":
    main()
