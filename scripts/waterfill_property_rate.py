"""How often the reference's water-filling property test fails on a draw.

``tests/test_power_control.py::test_waterfill_never_worse_than_corners``
draws 25 Hypothesis examples of (k, seed), k in [2, 8], seed in
[0, 10000], and asserts that ``solve_waterfill``'s objective is within
1e-7 of every one of ten random {0,1}^k corners. This script runs that
same check on every (k, seed) of the domain and prints the share that
fails, and the chance that a run of 25 uniform draws meets at least one.

    PYTHONPATH=src python scripts/waterfill_property_rate.py

About three minutes on one CPU core.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from repro.core.boxqp import solve_waterfill  # noqa: E402
from test_power_control import _rand_problem  # noqa: E402

EXAMPLES_PER_RUN = 25


def fails(k: int, seed: int) -> bool:
    rng = np.random.default_rng(seed)
    prob = _rand_problem(rng, k)
    objective = solve_waterfill(prob).objective
    for _ in range(10):
        corner = rng.integers(0, 2, k).astype(float)
        if not objective <= prob.objective(corner) + 1e-7:
            return True
    return False


def main() -> None:
    draws = [(k, seed) for k in range(2, 9) for seed in range(10_001)]
    bad = [d for d in draws if fails(*d)]
    share = len(bad) / len(draws)
    print(f"{len(bad)} of {len(draws)} (k, seed) draws fail: {share:.4%}")
    print(f"a run of {EXAMPLES_PER_RUN} uniform draws fails with chance "
          f"{1 - (1 - share) ** EXAMPLES_PER_RUN:.1%}")
    print("first failing draws:", bad[:10])


if __name__ == "__main__":
    main()
