"""Federation-engine benchmark, the batched half of the reference's
``benchmarks/fl_engine_bench.py``.

Two levels per K in {12, 100, 1000}:

* ``fl_engine/batched_k{K}`` — the engine alone: one full-federation
  broadcast (``BatchedEngine.local_train`` on all K clients, M=5 local
  steps each), steady state after the first call.
* ``fl_engine/server_batched_k{K}`` — a full host-path PAOTA server round
  (scheduler + P2 solve + AirComp on top of the engine), the rounds/sec a
  training run sees.

The reference's ``legacy`` rows (its per-client loop, and the speedup row
over it) are left out: the port has the batched engine only. A small
per-client size ladder at K=1000 keeps the padded federation small, as in
the reference. Times are wall-clock medians, each call ending in a
synchronize.
"""
from __future__ import annotations

import time

from repro_torch.bench.timing import median_s, sync
from repro_torch.core import ChannelConfig, SchedulerConfig
from repro_torch.data.partition import partition_noniid
from repro_torch.data.pipeline import build_federation
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl import (BatchedEngine, FLClient, PAOTAConfig,
                            PAOTAServer)
from repro_torch.models.mlp import init_mlp_params, mlp_loss
from repro_torch.tree import tree_map

_SIZES = {1000: (48, 64)}
KS = (12, 100, 1000)


def make_clients(k: int, seed: int = 0):
    """The reference's bench federation: make_mnist_like(seed=1234), the
    non-IID partition (the small ladder at K=1000), M=5, batch 32."""
    x, y, _, _ = make_mnist_like(n_train=min(max(100 * k, 2000), 20000),
                                 n_test=10, seed=1234)
    parts = partition_noniid(y, n_clients=k, sizes=_SIZES.get(k), seed=seed)
    fed = build_federation(x, y, parts, seed=seed)
    return [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
            for d in fed]


def _time_engine(k: int, reps: int, dev, seed: int = 0):
    """(seconds per full-federation broadcast, setup seconds): setup is
    engine construction (the federation's copy to the device) plus the
    first call."""
    params = tree_map(lambda t: t.to(dev), init_mlp_params(seed))
    ids = list(range(k))
    t0 = time.perf_counter()
    eng = BatchedEngine.from_clients(make_clients(k, seed), device=dev)
    eng.local_train(params, ids)
    sync(dev)
    setup = time.perf_counter() - t0
    return median_s(lambda: eng.local_train(params, ids), reps, dev), setup


def _time_server(k: int, reps: int, dev, seed: int = 0):
    t0 = time.perf_counter()
    srv = PAOTAServer(init_mlp_params(seed), make_clients(k, seed),
                      ChannelConfig(), SchedulerConfig(n_clients=k, seed=seed),
                      PAOTAConfig(seed=seed), device=dev)
    srv.round()                         # warm-up round
    sync(dev)
    setup = time.perf_counter() - t0
    return median_s(srv.round, reps, dev), setup


def run(device=None, ks=KS) -> list:
    dev = resolve_device(device)
    rows = []
    for k in ks:
        reps = 3 if k >= 1000 else 7
        sec, setup = _time_engine(k, reps, dev)
        rows.append({"name": f"fl_engine/batched_k{k}",
                     "us_per_call": round(sec * 1e6, 1),
                     "derived": f"broadcasts_per_sec={1.0 / sec:.3f};"
                                f"setup_s={setup:.2f}"})
        ssec, ssetup = _time_server(k, reps, dev)
        rows.append({"name": f"fl_engine/server_batched_k{k}",
                     "us_per_call": round(ssec * 1e6, 1),
                     "derived": f"rounds_per_sec={1.0 / ssec:.3f};"
                                f"setup_s={ssetup:.2f}"})
    return rows


if __name__ == "__main__":
    print("name,us_per_call,derived")
    for row in run():
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
