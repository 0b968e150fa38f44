"""Fig. 3 reproduction: train-loss gap vs communication rounds for PAOTA /
Local SGD / COTAF under N0 = -174 dBm/Hz and the high-noise -74 dBm/Hz
regime (PAOTA's noise-aware power control should be the more robust one).

The port's ``benchmarks/fig3.py``: rows ``name,us_per_call,derived`` plus
the per-round trajectory CSV ``fig3_trajectories.csv`` under
``common.out_dir()``. ``setting`` overrides ``BenchSetting`` fields (e.g.
``engine="fused"``)."""
from __future__ import annotations

import os
import time

from repro_torch.bench import common
from repro_torch.fl import write_csv

ALGOS = ("paota", "local_sgd", "cotaf")
NOISE_LEVELS = (-174.0, -74.0)


def run(device=None, **setting) -> list:
    rows_out = []
    traj = []
    for n0 in NOISE_LEVELS:
        s = common.BenchSetting.from_env(n0_dbm_hz=n0, **setting)
        clients, params, data = common.build_world(s)
        for algo in ALGOS:
            t0 = time.time()
            rows = common.run_algorithm(algo, s, clients, params, data,
                                        device=device)
            for r in rows:
                r["n0_dbm_hz"] = n0
            traj.extend(rows)
            final = rows[-1]
            rows_out.append({
                "name": f"fig3_{algo}_n0{int(n0)}",
                "us_per_call": round((time.time() - t0) * 1e6 / s.n_rounds, 1),
                "derived": f"final_loss={final['loss']}"
                           f";final_acc={final['accuracy']}",
            })
    write_csv(os.path.join(common.out_dir(), "fig3_trajectories.csv"), traj)
    return rows_out


if __name__ == "__main__":
    for row in run():
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
