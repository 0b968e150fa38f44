"""Bench differ: compare the current run's BENCH_<name>.json artifacts
against a baseline run's and fail on wall-clock regressions.

    python -m repro_torch.bench.diff --baseline <dir>
        [--current experiments/bench_torch] [--ratio 2.0] [--min-us 1000]
        [names ...]

The port's ``benchmarks/diff.py``, same rules and exit codes; the current
directory defaults to ``$REPRO_BENCH_OUT`` or ``experiments/bench_torch``.

For every artifact present in BOTH directories, rows are matched by their
``name`` field and the ``us_per_call`` wall-clock compared. A row whose
current time exceeds ``ratio`` x its baseline (default 2.0 — the CI
regression bar) is a regression; the process exits nonzero if any row
regressed. Rows faster than ``--min-us`` in the baseline (default 1 ms)
are reported but never fail the run — micro-rows on shared CI cores are
dominated by scheduler noise, not code. Rows (or whole artifacts) with no
baseline entry are flagged ``new (no baseline)`` and never fail — a newly
introduced series must survive its first CI run; it becomes gated once
its artifact is committed. An artifact whose baseline was
recorded on a different backend or device count is likewise report-only:
absolute wall clocks only gate on a like-for-like environment (for
machine-speed drift, raise the bar with ``REPRO_BENCH_DIFF_RATIO``).

Positional ``names`` restrict the comparison to specific artifacts (e.g.
``fused_round_smoke``).

Exit codes: 0 ok / nothing comparable, 1 regression found, 2 bad usage.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional


def load_artifacts(dirname: str, names: Optional[List[str]] = None) -> Dict:
    """{artifact name: {"rows": {row name: us_per_call}, "env": (backend,
    device_count) or None}} for every BENCH_*.json."""
    out = {}
    for path in sorted(glob.glob(os.path.join(dirname, "BENCH_*.json"))):
        base = os.path.basename(path)[len("BENCH_"):-len(".json")]
        if names and base not in names:
            continue
        try:
            with open(path) as f:
                art = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"# skipping unreadable {path}: {e}", file=sys.stderr)
            continue
        rows = {}
        for row in art.get("rows", []):
            if "name" in row and "us_per_call" in row:
                try:
                    rows[str(row["name"])] = float(row["us_per_call"])
                except (TypeError, ValueError):
                    continue
        env = None
        if "backend" in art and "device_count" in art:
            env = (art["backend"], art["device_count"])
        if rows:
            out[base] = {"rows": rows, "env": env}
    return out


def diff_artifacts(baseline: Dict, current: Dict, ratio: float,
                   min_us: float):
    """Returns (report rows, regressions). A report row is
    (artifact, row, base_us, cur_us, factor, flag). An artifact whose
    baseline was recorded on a different backend or device count is
    reported but never failed — absolute wall clocks are only comparable
    on a like-for-like environment."""
    report, regressions = [], []
    for art, cur in sorted(current.items()):
        base = baseline.get(art)
        if not base or not base["rows"]:
            # a whole artifact with no baseline: a newly-introduced series
            # — report it so the introduction is visible, never fail it
            for name, cur_us in sorted(cur["rows"].items()):
                report.append((art, name, 0.0, cur_us, 0.0,
                               "new (no baseline)"))
            continue
        env_mismatch = (base["env"] is not None and cur["env"] is not None
                        and base["env"] != cur["env"])
        base_rows = base["rows"]
        for name, cur_us in cur["rows"].items():
            base_us = base_rows.get(name)
            if base_us is None:
                # newly-added row inside an existing artifact: first
                # introduction must not fail the differ
                report.append((art, name, 0.0, cur_us, 0.0,
                               "new (no baseline)"))
                continue
            if base_us <= 0:
                # pre-existing sentinel/ratio row (us_per_call 0) — not
                # new, not comparable: skip silently as always
                continue
            factor = cur_us / base_us
            flag = ""
            if factor > ratio:
                if env_mismatch:
                    flag = "env mismatch (backend/devices differ)"
                elif base_us >= min_us:
                    flag = "REGRESSION"
                    regressions.append((art, name, base_us, cur_us, factor))
                else:
                    flag = "noise (baseline < min-us)"
            report.append((art, name, base_us, cur_us, factor, flag))
    return report, regressions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fail on >ratio x wall-clock regressions vs the "
                    "baseline run's BENCH_*.json artifacts")
    ap.add_argument("--baseline", required=True,
                    help="directory with the previous artifacts")
    ap.add_argument("--current", default=os.environ.get(
        "REPRO_BENCH_OUT", "experiments/bench_torch"))
    ap.add_argument("--ratio", type=float,
                    default=float(os.environ.get("REPRO_BENCH_DIFF_RATIO",
                                                 "2.0")))
    ap.add_argument("--min-us", type=float, default=1000.0,
                    help="baseline rows faster than this never fail "
                         "(micro-row noise floor)")
    ap.add_argument("names", nargs="*",
                    help="restrict to these artifact names")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.baseline):
        print(f"baseline dir {args.baseline!r} does not exist",
              file=sys.stderr)
        return 2

    baseline = load_artifacts(args.baseline, args.names or None)
    current = load_artifacts(args.current, args.names or None)
    report, regressions = diff_artifacts(baseline, current, args.ratio,
                                         args.min_us)
    if not report:
        print("# bench diff: no comparable artifact rows "
              f"(baseline {len(baseline)}, current {len(current)})")
        return 0
    print(f"# bench diff vs {args.baseline} (fail ratio {args.ratio}x, "
          f"noise floor {args.min_us}us)")
    print("artifact,row,baseline_us,current_us,factor,flag")
    for art, name, b, c, f, flag in report:
        print(f"{art},{name},{b:.1f},{c:.1f},{f:.2f},{flag}")
    if regressions:
        print(f"# {len(regressions)} regression(s) > {args.ratio}x:",
              file=sys.stderr)
        for art, name, b, c, f in regressions:
            print(f"#   {art}:{name} {b:.0f}us -> {c:.0f}us ({f:.2f}x)",
                  file=sys.stderr)
        return 1
    print("# bench diff ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
