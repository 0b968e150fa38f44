#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/csrc`` with nvcc (into ``build/repro_torch``), holds each
kernel against its plain-torch twin on the card, drives the fused PAOTA
round at the paper's size through ``FusedPAOTA.advance`` (K = 100 clients,
the 784-10-10-10 MLP, 100 rounds per transmit mode) and at K = 1000, times
the kernels, and prints one JSON record per phase. Its last three lines
are the ``kernels`` record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; without a GPU, or outside a checkout, it exits 2 at once.

It imports torch, numpy and the port only.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# data-sheet HBM bandwidth (bytes/s) and f32 rate outside the tensor cores
# (FLOP/s) at the full power limit, matched on the device name in order
CARDS = (("H200", 4.8e12, 67e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H100 NVL", 3.9e12, 60e12), ("H100", 3.35e12, 67e12))

PARITY_SHAPES = ((1, 1), (3, 511), (100, 8070), (1000, 8070))
MAIN_ROUNDS = 100
SCALE_ROUNDS = 20
TIMING_RUNS = 60


def log(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_rates(name: str):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no data-sheet rates for {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: every kernel against its twin on the card
# ---------------------------------------------------------------------------

def _tol(dtype):
    # the reference's kernel tolerances (tests/test_kernels.py,
    # tests/test_round_stats.py)
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=3e-5, atol=3e-4))


def parity(dev):
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    worst = {"round_stats": 0.0, "superpose_normalize": 0.0}
    main_err = {}
    cases = 0
    for k, d in PARITY_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(k * 8191 + d)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            pay = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            g = torch.randn((d,), generator=gen, device=dev)
            for payload in (None, pay):
                got, got_g = rs.round_stats_cuda(x, g, payload)
                want, want_g = rs.round_stats_plain(x, g, payload)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **_tol(dtype))
                torch.testing.assert_close(got_g, want_g, rtol=3e-5,
                                           atol=0.0)
                err = float((got - want).abs().max())
                worst["round_stats"] = max(worst["round_stats"], err)
                if (k, d, dtype, payload is not None) == (
                        100, 8070, torch.float32, True):
                    main_err["round_stats"] = err
                cases += 1
            p = 0.1 + 15.0 * torch.rand((k,), generator=gen, device=dev)
            noise = 2.8e-7 * torch.randn((d,), generator=gen, device=dev)
            masks = {"zero": torch.zeros((k,), device=dev),
                     "partial": (torch.rand((k,), generator=gen, device=dev)
                                 < 0.5).float(),
                     "full": torch.ones((k,), device=dev)}
            for kind, m in masks.items():
                got, raw = ac.superpose_normalize_cuda(x, p, m, noise)
                want, want_raw = ac.superpose_normalize_plain(x, p, m, noise)
                torch.cuda.synchronize()
                tol = (_tol(dtype) if dtype == torch.bfloat16
                       else dict(rtol=3e-5, atol=3e-5))
                torch.testing.assert_close(got, want, **tol)
                torch.testing.assert_close(raw, want_raw, rtol=3e-5,
                                           atol=0.0)
                if kind == "zero" and float(raw) != 0.0:
                    raise AssertionError("all-zero mask: raw varsigma "
                                         f"{float(raw)} != 0")
                err = float((got - want).abs().max())
                if kind != "zero":      # zero mask: agg = noise / 1e-12
                    worst["superpose_normalize"] = max(
                        worst["superpose_normalize"], err)
                if (k, d, dtype, kind) == (100, 8070, torch.float32,
                                           "partial"):
                    main_err["superpose_normalize"] = err
                cases += 1
    log({"phase": "parity", "cases": cases, "all_close": True,
         "max_abs_err_at_main_shape": main_err,
         "max_abs_err_any_case": worst})
    return main_err


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------

def run_path(dev, data, *, k, sizes, transmit, rounds, tag):
    """Drive FusedPAOTA.advance for ``rounds`` rounds with the launch
    counters set to 0 just before and read just after."""
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.data.partition import partition_noniid
    from repro_torch.data.pipeline import build_federation
    from repro_torch.fl import FLClient, FusedPAOTA, PAOTAConfig
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    from repro_torch.models.mlp import init_mlp_params, mlp_accuracy, mlp_loss
    x, y, xt, yt = data
    parts = partition_noniid(y, n_clients=k, sizes=sizes, seed=0)
    clients = [FLClient(c, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for c in build_federation(x, y, parts)]
    drv = FusedPAOTA(init_mlp_params(0), clients,
                     ChannelConfig(bandwidth_hz=20e6, n0_dbm_hz=-174.0,
                                   p_max_watts=15.0),
                     SchedulerConfig(n_clients=k, delta_t=8.0, lat_lo=5.0,
                                     lat_hi=15.0, seed=1),
                     PAOTAConfig(omega=3.0, smooth_l=10.0, eps_bound=0.05,
                                 transmit=transmit, seed=0),
                     device=dev)
    test = {"x": torch.as_tensor(xt, device=dev),
            "y": torch.as_tensor(yt, device=dev).long()}
    acc0 = float(mlp_accuracy(drv.global_params(), test))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = min(10, rounds)
    rs.launches = ac.launches = 0
    t0 = time.perf_counter()
    rows = drv.advance(warm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows += drv.advance(rounds - warm)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"round_stats": rs.launches, "superpose_normalize": ac.launches}
    acc = float(mlp_accuracy(drv.global_params(), test))
    g = drv.global_vec
    checks = {
        "finite": bool(np.isfinite(g).all()),
        "some_uploaders": any(r["n_participants"] > 0 for r in rows),
        "some_staleness": any(r["mean_staleness"] > 0 for r in rows),
        "accuracy_rose": acc > acc0,
        "launches_equal_rounds": all(v == rounds for v in launches.values()),
    }
    rec = {"phase": tag, "transmit": transmit, "clients": k,
           "model_dim": drv.d, "rounds": rounds,
           "ms_per_round": (t2 - t0) * 1e3 / rounds,
           "ms_per_round_after_warmup": (t2 - t1) * 1e3 / (rounds - warm),
           "accuracy_round0": acc0, "accuracy_final": acc,
           "mean_participants": float(np.mean([r["n_participants"]
                                               for r in rows])),
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
           "launches": launches, "checks": checks}
    log(rec)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{tag} transmit={transmit}: failed {failed}")
    return rec, drv


# ---------------------------------------------------------------------------
# phase 6: kernel times
# ---------------------------------------------------------------------------

def time_ms(fn, flush):
    """Median ms of one call, CUDA events around it, the L2 cache flushed
    before every call (the round finds the plane cold after local SGD)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMING_RUNS):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_times(dev, bw, flops):
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB
    out = {}
    for k, d in ((100, 8070), (1000, 8070)):
        gen = torch.Generator(device=dev).manual_seed(k)
        x = torch.randn((k, d), generator=gen, device=dev)
        pay = torch.randn((k, d), generator=gen, device=dev)
        g = torch.randn((d,), generator=gen, device=dev)
        p = 15.0 * torch.rand((k,), generator=gen, device=dev)
        m = (torch.rand((k,), generator=gen, device=dev) < 0.5).float()
        noise = 2.8e-7 * torch.randn((d,), generator=gen, device=dev)
        for payload in (pay, None):
            name = "round_stats" + ("" if payload is None else "+payload")
            planes = 1 if payload is None else 2
            nbytes = 4 * (planes * k * d + d + k * (planes + 1) + 1)
            nops = 2 * k * d * (planes + 1) + 2 * d
            out[(name, k)] = {
                "ms": time_ms(lambda: rs.round_stats_cuda(x, g, payload),
                              flush),
                "plain_ms": time_ms(
                    lambda: rs.round_stats_plain(x, g, payload), flush),
                "yardstick_ms": time_ms(lambda: x @ g, flush),
                "yardstick": "x @ g (partial: the dot column only)",
                "bound_ms": max(nbytes / bw, nops / flops) * 1e3,
                "bound_by": "bytes" if nbytes / bw >= nops / flops
                else "operations"}
        nbytes = 4 * (k * d + 2 * k + 2 * d + 1)
        nops = 2 * k * d + k + 2 * d
        out[("superpose_normalize", k)] = {
            "ms": time_ms(lambda: ac.superpose_normalize_cuda(
                x, p, m, noise), flush),
            "plain_ms": time_ms(lambda: ac.superpose_normalize_plain(
                x, p, m, noise), flush),
            "yardstick_ms": time_ms(lambda: torch.mv(x.t(), p * m),
                                    flush),
            "yardstick": "torch.mv(x.t(), bp) (partial: the contraction "
                         "only)",
            "bound_ms": max(nbytes / bw, nops / flops) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= nops / flops
            else "operations"}
    for (name, k), rec in out.items():
        log({"phase": "kernel_time", "kernel": name, "shape": [k, 8070],
             "dtype": "float32", **rec})
    return out


def stage_times(drv, flush):
    """ms of the round's two heaviest non-kernel stages at the main path's
    shapes: local SGD for all K clients, and the water-filling P2 solve."""
    from repro_torch.core.boxqp import waterfill_beta
    k = drv.k
    params = drv.global_params()
    plan = drv.draws.batch_plan(1)
    dev = plan.device
    rho = torch.rand((k,), device=dev)
    theta = torch.rand((k,), device=dev)
    pm = torch.full((k,), 15.0, device=dev)
    b = (torch.rand((k,), device=dev) < 0.4).float()
    rec = {"phase": "stage_time", "clients": k,
           "local_sgd_ms": time_ms(
               lambda: drv.engine.train_all(params, plan), flush),
           "waterfill_ms": time_ms(
               lambda: waterfill_beta(rho, theta, pm, b,
                                             drv._rcfg.c1, drv._rcfg.c0),
               flush)}
    log(rec)


def no_host_sync(drv) -> None:
    """Three more rounds of the main path with torch's sync debug mode set
    to error: a round must read nothing back to the host between stages
    (the one copy per advance comes after scan_rounds)."""
    from repro_torch.fl.runtime import scan_rounds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            drv._carry, _ = scan_rounds(drv._carry, 3, rcfg=drv._rcfg,
                                        streams=drv._streams)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log({"phase": "no_host_sync", "rounds": 3, "ok": True})


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda is not available; this smoke needs "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.data.partition import FAST_SIZES, PAPER_SIZES
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.device import full_f32_matmul
    from repro_torch.kernels import build

    # 1. environment
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(name)
    full_f32_matmul()
    log({"phase": "environment", "nvidia_smi": smi, "device": name,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "tf32": [torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32],
         "hbm_bytes_per_s": bw, "f32_flops": flops})

    # 2. build both kernels from the checkout's sources, in parallel
    seconds = build.build_all()
    log({"phase": "build", "sources": list(build.SOURCES),
         "seconds": seconds, "arch": "sm_90a"})

    # 3. kernel parity on the card
    main_err = parity(dev)

    # 4. the main path at the paper's size, both transmit modes
    t = time.perf_counter()
    data = make_mnist_like(n_train=60000, n_test=10000, seed=1234)
    log({"phase": "data", "n_train": 60000, "n_test": 10000,
         "seconds": time.perf_counter() - t})
    launches = {"round_stats": 0, "superpose_normalize": 0}
    by_path = {}
    drv_main = None
    for transmit in ("model", "delta"):
        rec, drv = run_path(dev, data, k=100, sizes=PAPER_SIZES,
                            transmit=transmit, rounds=MAIN_ROUNDS,
                            tag="main_path")
        by_path[transmit] = rec["launches"]
        for key in launches:
            launches[key] += rec["launches"][key]
        if transmit == "model":
            drv_main = drv

    no_host_sync(drv_main)

    # 5. scale: K = 1000
    run_path(dev, data, k=1000, sizes=FAST_SIZES, transmit="delta",
             rounds=SCALE_ROUNDS, tag="scale")

    # 6. kernel and stage times
    times = kernel_times(dev, bw, flops)
    stage_times(drv_main,
                torch.empty(64 * 2**20, dtype=torch.float32, device=dev))

    sources = {"round_stats": ("round_stats+payload",
                               "src/repro_torch/csrc/round_stats.cu",
                               "src/repro/kernels/round_stats.py:112"),
               "superpose_normalize": ("superpose_normalize",
                                       "src/repro_torch/csrc/aircomp_sum.cu",
                                       "src/repro/kernels/aircomp_sum.py:119")}
    kernels = []
    for kname, (tkey, source, replaces) in sources.items():
        t = times[(tkey, 100)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "launches_by_path": {p: v[kname] for p, v in by_path.items()},
            "max_abs_err": main_err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "yardstick_ms": t["yardstick_ms"], "yardstick": t["yardstick"],
            "shape": [100, 8070], "dtype": "float32"})
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
