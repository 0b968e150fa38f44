"""Federated-learning launcher for the port: PAOTA's fused round on the
non-IID synthetic MNIST federation (Section IV), on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.fl_train --rounds 100 \\
        --clients 100 --transmit model [--device cuda|cpu]

Runs ``repro_torch.fl.FusedPAOTA`` (counter-keyed draws) and prints, after
every round, the simulated time, the test accuracy and loss of the global
model, the round's participants, and the round's wall milliseconds
(measured after a device synchronize) — the reference CLI's fused-engine
trajectory (``repro.launch.fl_train --engine fused``), whose baselines and
CSV output have no port yet. The federation is the reference CLI's: the
scaled-down size ladder, seed 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import ChannelConfig, SchedulerConfig
from repro_torch.data.partition import partition_noniid
from repro_torch.data.pipeline import build_federation
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl import FLClient, FusedPAOTA, PAOTAConfig
from repro_torch.models.mlp import (init_mlp_params, mlp_accuracy, mlp_loss)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--transmit", default="model", choices=["model", "delta"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    k = args.clients
    x, y, xt, yt = make_mnist_like(n_train=max(200 * k, 4000), n_test=2000)
    parts = partition_noniid(y, n_clients=k, seed=0)
    clients = [FLClient(c, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for c in build_federation(x, y, parts)]
    drv = FusedPAOTA(init_mlp_params(0), clients, ChannelConfig(),
                     SchedulerConfig(n_clients=k),
                     PAOTAConfig(transmit=args.transmit), device=dev)
    test = {"x": torch.as_tensor(xt, device=dev),
            "y": torch.as_tensor(yt, device=dev).long()}
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"PAOTA fused round on {dev} ({name}): K={k}, d={drv.d}, "
          f"transmit={args.transmit}")
    print(f"{'round':>6} {'time_s':>8} {'acc':>7} {'loss':>8} "
          f"{'uploads':>7} {'ms/round':>9}")
    for _ in range(args.rounds):
        _sync(dev)
        t0 = time.perf_counter()
        row = drv.round()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            params = drv.global_params()
            acc = float(mlp_accuracy(params, test))
            loss = float(mlp_loss(params, test))
        print(f"{row['round']:>6} {row['time']:>8.1f} {acc:>7.4f} "
              f"{loss:>8.4f} {row['n_participants']:>7} {ms:>9.2f}")
    print(f"\n=== paota (port) === final acc {acc:.3f} @ sim "
          f"{row['time']:.0f}s")


if __name__ == "__main__":
    main()
