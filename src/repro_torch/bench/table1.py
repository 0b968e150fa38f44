"""Table I reproduction: rounds and simulated time to reach each target
test accuracy, per algorithm. The paper's claim: PAOTA needs MORE rounds
but LESS time than ideal Local SGD (e.g. -25% time to 80%).

The port's ``benchmarks/table1.py``; the table is ``table1.csv`` under
``common.out_dir()``."""
from __future__ import annotations

import os
import time

from repro_torch.bench import common
from repro_torch.fl import time_to_accuracy, write_csv

TARGETS = (0.5, 0.6, 0.7, 0.8)
ALGOS = ("paota", "local_sgd", "cotaf")


def run(device=None, **setting) -> list:
    s = common.BenchSetting.from_env(**setting)
    clients, params, data = common.build_world(s)
    rows_out, table = [], []
    for algo in ALGOS:
        t0 = time.time()
        rows = common.run_algorithm(algo, s, clients, params, data,
                                    device=device)
        tta = time_to_accuracy(rows, TARGETS)
        derived = []
        for tgt, (rnd, tm) in tta.items():
            table.append({"algo": algo, "target": tgt, "round": rnd,
                          "time_s": tm})
            derived.append(f"acc{int(tgt * 100)}@"
                           f"{'-' if tm is None else round(tm, 1)}s")
        rows_out.append({
            "name": f"table1_{algo}",
            "us_per_call": round((time.time() - t0) * 1e6 / s.n_rounds, 1),
            "derived": ";".join(derived),
        })
    write_csv(os.path.join(common.out_dir(), "table1.csv"), table)
    return rows_out


if __name__ == "__main__":
    for row in run():
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
