"""Quickstart: PAOTA federated training on a synthetic non-IID MNIST-like
task — 20 clients, 15 rounds, compared against ideal Local SGD.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The port's ``examples/quickstart.py``; it runs on the card unless asked
for the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.core import ChannelConfig, SchedulerConfig
from repro_torch.data.partition import partition_noniid
from repro_torch.data.pipeline import build_federation
from repro_torch.data.synthetic import get_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import (FLClient, LocalSGDServer, PAOTAConfig,
                            PAOTAServer, SyncConfig, evaluate)
from repro_torch.models.mlp import init_mlp_params, mlp_apply, mlp_loss

N_CLIENTS, N_ROUNDS = 20, 15


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    x_tr, y_tr, x_te, y_te = get_dataset(n_train=4000, n_test=1000)
    parts = partition_noniid(y_tr, n_clients=N_CLIENTS, seed=0)
    fed = build_federation(x_tr, y_tr, parts)
    clients = [FLClient(d, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for d in fed]
    params = init_mlp_params(0)

    paota = PAOTAServer(params, clients, ChannelConfig(),
                        SchedulerConfig(n_clients=N_CLIENTS, seed=1),
                        PAOTAConfig(solver="waterfill"), device=dev)
    sync = LocalSGDServer(params, clients,
                          SchedulerConfig(n_clients=N_CLIENTS, seed=2),
                          SyncConfig(n_select=10), device=dev)

    print(f"{'round':>5} {'PAOTA acc':>10} {'PAOTA t(s)':>10} "
          f"{'LocalSGD acc':>13} {'LocalSGD t(s)':>13}")
    rows = []
    for r in range(N_ROUNDS):
        paota.round()
        sync.round()
        if r % 3 == 2:
            a1 = evaluate(paota.global_params(), x_te, y_te, mlp_apply)
            a2 = evaluate(sync.global_params(), x_te, y_te, mlp_apply)
            rows.append((r, a1["accuracy"], paota.scheduler.time,
                         a2["accuracy"], sync.time))
            print(f"{r:>5} {a1['accuracy']:>10.3f} "
                  f"{paota.scheduler.time:>10.1f} "
                  f"{a2['accuracy']:>13.3f} {sync.time:>13.1f}")
    print("\nPAOTA fixed-period rounds vs sync straggler-bound rounds — "
          "same takeaway as paper Fig. 4 / Table I.")
    return rows


if __name__ == "__main__":
    main()
