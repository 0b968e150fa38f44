"""Canonical tracked round-perf series: the PAOTA delta plane.

The port's ``benchmarks/round_perf_bench.py``: the cross-run perf
trajectory of the aggregation period itself — the (K, d) data-plane
arithmetic (eq.-25 stats, water-filled powers, AirComp superposition,
carry update) that the two sweep kernels carry. The model is sized so
that plane dominates: an MLP with ``REPRO_BENCH_HIDDEN`` (default 64)
hidden units gives d = 55,050, and local training is held to ONE local
SGD step on batch 1.

Per K in {16, 1000} (smoke: K=16 only):

* ``round_perf/host_raveled_k{K}``    — host-path seconds/round
  (``PAOTAServer``, counter draws + ``waterfill_jnp``: the fused round's
  math, host-staged).
* ``round_perf/fused_raveled_k{K}``   — ``FusedPAOTA`` seconds/round,
  steady state, over one R-round ``advance`` (transmit='model').
* ``round_perf/fused_pytree_k{K}``    — same, params carried as a dict.
* ``round_perf/fused_{raveled,pytree}_delta_k{K}`` — transmit='delta':
  the carry is the delta plane (no pending stack).

The reference's ``sharded_*`` rows (``ShardedPAOTA`` over a forced
8-device CPU mesh) are left out: the sharded engine is not ported.
``python -m repro_torch.bench.round_perf_bench smoke`` writes
``BENCH_round_perf_smoke.json``, the full run ``BENCH_round_perf.json``.
"""
from __future__ import annotations

import argparse
import os
from functools import partial

from repro_torch.bench.common import write_bench_artifact
from repro_torch.bench.fused_round_bench import time_fused, time_host
from repro_torch.data.partition import partition_noniid
from repro_torch.data.pipeline import build_federation
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl import BatchedEngine
from repro_torch.models.mlp import init_mlp_params, mlp_loss

_ROUNDS = {16: 20, 1000: 5}          # rounds per advance per federation size
_BATCH, _STEPS, _SIZES = 1, 1, (16, 24)


def _hidden() -> int:
    return int(os.environ.get("REPRO_BENCH_HIDDEN", "64"))


def _make_engine(k: int, dev, seed: int = 0) -> BatchedEngine:
    x, y, _, _ = make_mnist_like(n_train=min(max(20 * k, 2000), 20000),
                                 n_test=10, seed=1234)
    parts = partition_noniid(y, n_clients=k, sizes=_SIZES, seed=seed)
    fed = build_federation(x, y, parts, seed=seed)
    return BatchedEngine(fed, mlp_loss, batch_size=_BATCH, lr=0.1,
                         local_steps=_STEPS, device=dev)


def _world(k: int, dev, seed: int = 0):
    """(params, engine) of the hidden-``REPRO_BENCH_HIDDEN`` MLP."""
    return init_mlp_params(seed, hidden=_hidden()), _make_engine(k, dev, seed)


def _row(name: str, sec: float, setup: float, rounds: int) -> dict:
    return {"name": name, "us_per_call": round(sec * 1e6, 1),
            "derived": f"rounds_per_sec={1.0 / sec:.3f};"
                       f"scan_rounds={rounds};setup_s={setup:.2f}"}


def run(device=None, ks=(16, 1000)) -> list:
    dev = resolve_device(device)
    rows = []
    for k in ks:
        rounds, world = _ROUNDS[k], partial(_world, k, dev)
        rows.append(_row(f"round_perf/host_raveled_k{k}",
                         *time_host(world, k, rounds, dev), rounds))
        for mode in ("raveled", "pytree"):
            for transmit, suffix in (("model", ""), ("delta", "_delta")):
                sec, setup = time_fused(world, k, rounds, dev,
                                        transmit=transmit, params_mode=mode)
                rows.append(_row(f"round_perf/fused_{mode}{suffix}_k{k}",
                                 sec, setup, rounds))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["smoke"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    smoke = args.mode == "smoke"
    ks = (16,) if smoke else (16, 1000)
    rows = run(args.device, ks=ks)
    print("name,us_per_call,derived")
    for row in rows:
        print(f"{row['name']},{row['us_per_call']},{row['derived']}",
              flush=True)
    name = "round_perf_smoke" if smoke else "round_perf"
    path = write_bench_artifact(name, rows, device=args.device,
                                extra={"ks": list(ks), "hidden": _hidden(),
                                       "batch": _BATCH,
                                       "local_steps": _STEPS})
    print(f"# artifact -> {path}", flush=True)


if __name__ == "__main__":
    main()
