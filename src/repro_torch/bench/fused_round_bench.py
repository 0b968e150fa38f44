"""Fused on-device PAOTA round vs the host-path round.

The port's ``benchmarks/fused_round_bench.py``. The host path
(``PAOTAServer.round``) stages each period through the host (the P2
solve, the scheduler); the fused path (``FusedPAOTA.advance``) runs the
whole round — scheduler, eq.-25 factors, water-filling P2, channel,
power cap (7), AirComp, broadcast + local train — on the device, R rounds
per call.

Per K in {100, 1000}:

* ``fused_round/host_k{K}``    — host-path seconds/round (counter draws,
  ``waterfill_jnp``, steady state after a warm-up round).
* ``fused_round/fused_k{K}``   — fused seconds/round from one R-round
  ``advance`` (steady state: the second call; the first is setup_s).
* ``fused_round/speedup_k{K}`` — host / fused.

Both paths run the counter draws and the f32 water-filling, so they
execute the same math; the comparison is host orchestration against the
on-device round. ``python -m repro_torch.bench.fused_round_bench smoke``
runs K=8, R=5 and writes ``BENCH_fused_round_smoke.json``.
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np

from repro_torch.bench.common import write_bench_artifact
from repro_torch.bench.fl_engine_bench import make_clients
from repro_torch.bench.timing import sync
from repro_torch.core import ChannelConfig, SchedulerConfig
from repro_torch.device import resolve_device
from repro_torch.fl import FusedPAOTA, PAOTAConfig, PAOTAServer
from repro_torch.models.mlp import init_mlp_params

_ROUNDS = {8: 5, 100: 20, 1000: 10}


def _world(k: int, seed: int = 0):
    """(params, clients) of the paper's MLP over K synthetic clients."""
    return init_mlp_params(seed), make_clients(k, seed)


def time_host(world, k: int, rounds: int, dev, seed: int = 0):
    """Host-path seconds/round over ``rounds`` steady-state rounds, and
    the setup seconds (``world()`` -> (params, clients) included, and a
    warm-up round that takes every lazy path once)."""
    t0 = time.perf_counter()
    params, clients = world()
    srv = PAOTAServer(params, clients, ChannelConfig(),
                      SchedulerConfig(n_clients=k, seed=seed, rng="counter"),
                      PAOTAConfig(rng="counter", solver="waterfill_jnp",
                                  seed=seed), device=dev)
    srv.round()
    sync(dev)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(rounds):
        srv.round()
    sync(dev)
    return (time.perf_counter() - t0) / rounds, setup


def time_fused(world, k: int, rounds: int, dev, seed: int = 0,
               transmit: str = "model", **fused_kw):
    """Fused seconds/round from one steady-state ``advance(rounds)`` (the
    first call, with ``world()``, is the setup), ``fused_kw`` passed to
    ``FusedPAOTA``."""
    t0 = time.perf_counter()
    params, clients = world()
    srv = FusedPAOTA(params, clients, ChannelConfig(),
                     SchedulerConfig(n_clients=k, seed=seed),
                     PAOTAConfig(seed=seed, transmit=transmit), device=dev,
                     **fused_kw)
    srv.advance(rounds)               # carry init + first run
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.advance(rounds)               # steady state (ends in a host copy)
    sec = (time.perf_counter() - t0) / rounds
    assert np.isfinite(srv.global_vec).all()
    return sec, setup


def run(device=None, ks=(100, 1000)) -> list:
    dev = resolve_device(device)
    rows = []
    for k in ks:
        rounds = _ROUNDS.get(k, 10)
        world = partial(_world, k)
        host_s, host_setup = time_host(world, k, rounds, dev)
        rows.append({"name": f"fused_round/host_k{k}",
                     "us_per_call": round(host_s * 1e6, 1),
                     "derived": f"rounds_per_sec={1.0 / host_s:.3f};"
                                f"setup_s={host_setup:.2f}"})
        fused_s, fused_setup = time_fused(world, k, rounds, dev)
        rows.append({"name": f"fused_round/fused_k{k}",
                     "us_per_call": round(fused_s * 1e6, 1),
                     "derived": f"rounds_per_sec={1.0 / fused_s:.3f};"
                                f"scan_rounds={rounds};"
                                f"setup_s={fused_setup:.2f}"})
        rows.append({"name": f"fused_round/speedup_k{k}",
                     "us_per_call": 0,
                     "derived": f"{host_s / fused_s:.2f}x"})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["smoke"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    smoke = args.mode == "smoke"
    dev = args.device
    rows = run(dev, ks=(8,) if smoke else (100, 1000))
    print("name,us_per_call,derived")
    for row in rows:
        print(f"{row['name']},{row['us_per_call']},{row['derived']}",
              flush=True)
    name = "fused_round_smoke" if smoke else "fused_round"
    path = write_bench_artifact(name, rows, device=dev)
    print(f"# artifact -> {path}", flush=True)


if __name__ == "__main__":
    main()
