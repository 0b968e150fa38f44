"""Fig. 4 reproduction: test accuracy vs rounds AND vs simulated wall time
(N0 = -174 dBm/Hz). The wall-time view is the paper's headline: PAOTA's
fixed delta_t rounds beat the sync baselines' straggler-bound rounds.

The port's ``benchmarks/fig4.py``; the trajectory CSV is
``fig4_trajectories.csv`` under ``common.out_dir()``."""
from __future__ import annotations

import os
import time

from repro_torch.bench import common
from repro_torch.fl import write_csv

ALGOS = ("paota", "local_sgd", "cotaf")


def run(device=None, **setting) -> list:
    s = common.BenchSetting.from_env(**setting)
    clients, params, data = common.build_world(s)
    rows_out, traj = [], []
    for algo in ALGOS:
        t0 = time.time()
        rows = common.run_algorithm(algo, s, clients, params, data,
                                    device=device)
        traj.extend(rows)
        final = rows[-1]
        rows_out.append({
            "name": f"fig4_{algo}",
            "us_per_call": round((time.time() - t0) * 1e6 / s.n_rounds, 1),
            "derived": f"final_acc={final['accuracy']}"
                       f";sim_time_s={final['time']}",
        })
    write_csv(os.path.join(common.out_dir(), "fig4_trajectories.csv"), traj)
    return rows_out


if __name__ == "__main__":
    for row in run():
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
