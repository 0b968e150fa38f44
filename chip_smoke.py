#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/csrc`` with nvcc (into ``build/repro_torch``), holds each
kernel against its plain-torch twin on the card, and drives the port's
paths at the paper's size (K = 100 clients, the 784-10-10-10 MLP):

- the fused PAOTA round through ``FusedPAOTA.advance`` (100 rounds per
  transmit mode, and K = 1000);
- the host-path ``PAOTAServer`` (30 rounds without and 30 with
  ``use_kernel``, the ``aircomp_sum`` kernel's route), held against the
  fused round on the same counter draws;
- ``cosine_similarity(use_kernel=True)`` on that run's delta plane (the
  ``cosine_partials`` kernel);
- the Local SGD and COTAF baselines (30 rounds each);
- the active cohort (``FusedPAOTA(cohort_size=64)`` at K = 1000): the
  uncompressed cohort and compressed payloads (randmask, top-k, int8
  slots), the ``gather_superpose`` kernel's path, and once more under the
  availability-cycle + dropout + lognormal + het-steps scenario;
- the reference's million-client state plane (K = 10^6, m = 256,
  d = 16384) on the port's runtime with fabricated local updates;
- the LM slice: the SSD intra-chunk and sliding-window attention kernels
  against their twins (the reference's sweeps, the full-width mamba2 layer
  through the SSD kernel's grouped entry, on contiguous and on strided
  B and C, mixtral-8x22b's and zamba2-7b's attention at T = 4608,
  W = 4096), the attention kernel through its own entry point
  ``ops.swa_attention``, and mamba2-370m serving at full width (48
  layers, f32, random weights from a seed): batch 8, a 1,024-token prompt
  through the prefill step, 64 greedy decode steps, prefill -> decode
  continuity against a full forward, and a 300-token prompt.

It times the seven kernels and prints one JSON record per phase. Its last
three lines are the ``kernels`` record, the card's name and power limit, and
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

# data-sheet HBM bandwidth (bytes/s), f32 rate outside the tensor cores and
# dense TF32 tensor-core rate (FLOP/s) at the full power limit, matched on
# the device name in order
CARDS = (("H200", 4.8e12, 67e12, 495e12),
         ("H100 PCIe", 2.0e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 60e12, 418e12),
         ("H100", 3.35e12, 67e12, 495e12))

# the sweeps' parity shapes (K, D): odd D, D = 8070 (float2 loads), D % 8 ==
# 0 (16-byte loads), several passes per row in sweep 1 (K = 1, D = 20000)
# and several rounds of row loads per warp in sweep 2 (K = 1000, D = 511)
PARITY_SHAPES = ((1, 1), (3, 511), (64, 8191), (100, 8070), (100, 8192),
                 (1000, 8070), (1, 20000), (1000, 511))
MAIN_ROUNDS = 100
SCALE_ROUNDS = 20
HOST_ROUNDS = 30
PARITY_ROUNDS = 5
BASELINE_ROUNDS = 30
TIMING_RUNS = 60
COHORT_K, COHORT_M = 1000, 64
COHORT_WARM, COHORT_ROUNDS, SCENARIO_ROUNDS = 10, 50, 30
PLANE_K, PLANE_M, PLANE_D, PLANE_ROUNDS = 10**6, 256, 16384, 10
# the gather_superpose shapes (m, s, d): the cohort path's randmask 1/16 of
# the MLP, and the state plane's
GS_SHAPES = ((64, 504, 8070), (256, 1024, 16384))
# ssd_intra_chunk (G, Q, N, P): the reference's sweep and the full-width
# layer's G = batch 8 x 4 chunks x 32 heads at mamba2-370m's Q, N, P
SSD_MAIN = (1024, 256, 128, 64)
SSD_SHAPES = ((4, 32, 16, 32), (8, 64, 128, 64), (2, 256, 64, 64),
              (3, 128, 64, 32), SSD_MAIN)
# the grouped entry (Bz, NC, H, G, Q, N, P, offset of B in the conv output
# or None for contiguous B, C): mamba2-370m's prefill layer (8 x 1,024
# tokens, 32 heads sharing one group), and strided views of a conv output
# as the model hands them over
SSD_GROUPED = (8, 4, 32, 1, 256, 128, 64)
SSD_GROUPED_CASES = (SSD_GROUPED + (None,), SSD_GROUPED + (2048,),
                     (2, 3, 8, 2, 100, 40, 64, 3))
# swa_attention: the reference's sweep (T, S, D, W, causal) and two
# attention shapes of the zoo (H, Hkv, D) with their window
SWA_SWEEP = ((128, 128, 64, None, True), (200, 200, 32, 64, True),
             (256, 256, 64, 96, True), (256, 256, 128, 128, True),
             (64, 64, 16, None, False), (96, 96, 64, 32, True),
             (130, 130, 64, 64, True))
SWA_ZOO = {"mixtral-8x22b": (48, 8, 128), "zamba2-7b": (32, 32, 112)}
SWA_WINDOW, SWA_PARITY_T, SWA_TIME_T = 4096, 4608, 8192
# mamba2-370m serving: batch, prompt, decode steps, cache, short prompt,
# teacher-forced continuity steps
LM_BATCH, LM_PROMPT, LM_STEPS, LM_CACHE, LM_SHORT, CONT_STEPS = (
    8, 1024, 64, 2048, 300, 5)


def log(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_rates(name: str):
    for key, bw, flops, tf32 in CARDS:
        if key in name:
            return bw, flops, tf32
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
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import round_stats as rs
    worst = {"round_stats": 0.0, "superpose_normalize": 0.0,
             "aircomp_sum": 0.0, "cosine_partials": 0.0}
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
                # aircomp_sum takes bp already masked
                bp = p * m
                got = ac.aircomp_sum_cuda(x, bp, noise)
                want = ac.aircomp_sum_plain(x, bp, noise)
                torch.cuda.synchronize()
                if kind == "zero":          # noise / 1e-12: relative only
                    torch.testing.assert_close(got, want, rtol=3e-5,
                                               atol=0.0)
                else:
                    torch.testing.assert_close(got, want, **tol)
                    err = float((got - want).abs().max())
                    worst["aircomp_sum"] = max(worst["aircomp_sum"], err)
                if (k, d, dtype, kind) == (100, 8070, torch.float32,
                                           "partial"):
                    main_err["aircomp_sum"] = err
                cases += 1
            got = cs.cosine_partials_cuda(x, g)
            want = cs.cosine_partials_plain(x, g)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **_tol(dtype))
            err = float((got - want).abs().max())
            worst["cosine_partials"] = max(worst["cosine_partials"], err)
            if (k, d, dtype) == (100, 8070, torch.float32):
                main_err["cosine_partials"] = err
            cases += 1
    gs_cases, gs_worst = gather_superpose_parity(dev, main_err)
    cases += gs_cases
    worst["gather_superpose"] = gs_worst
    log({"phase": "parity", "cases": cases, "all_close": True,
         "max_abs_err_at_main_shape": main_err,
         "max_abs_err_any_case": worst})
    return main_err


def gs_inputs(dev, m, s, d, dtype, with_scale, seed):
    """gather_superpose inputs on the card: distinct support indices in
    each row (a randmask support per row), every third row dead (bp = 0)
    holding garbage values, the int8 values the full code range."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.argsort(torch.rand((m, d), generator=gen, device=dev),
                        dim=1)[:, :s].to(torch.int32).contiguous()
    if dtype == torch.int8:
        v = torch.randint(-127, 128, (m, s), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        v = (1e-2 * torch.randn((m, s), generator=gen, device=dev)).to(dtype)
    scale = (1e-4 + 1e-3 * torch.rand((m,), generator=gen, device=dev)
             if with_scale else None)
    bp = 0.1 + 15.0 * torch.rand((m,), generator=gen, device=dev)
    bp[1::3] = 0.0
    noise = 2.8e-7 * torch.randn((d,), generator=gen, device=dev)
    return v, idx, bp, noise, scale


def gather_superpose_parity(dev, main_err):
    """gather_superpose against its twin at both shapes: f32, bf16 and
    int8 values, each with and without the scale, dead rows included, the
    raw varsigma too, and two calls bit-identical (no atomics)."""
    from repro_torch.kernels import gather_superpose as gs
    cases, worst = 0, 0.0
    for m, s, d in GS_SHAPES:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for with_scale in (False, True):
                v, idx, bp, noise, scale = gs_inputs(
                    dev, m, s, d, dtype, with_scale, m * s + d + cases)
                got, raw = gs.gather_superpose_cuda(v, idx, bp, noise, d=d,
                                                    scale=scale)
                again, _ = gs.gather_superpose_cuda(v, idx, bp, noise, d=d,
                                                    scale=scale)
                want, want_raw = gs.gather_superpose_plain(
                    v, idx, bp, noise, d=d, scale=scale)
                torch.cuda.synchronize()
                # int8 values are exact, so f32's tolerance after the scale
                tol = (_tol(dtype) if dtype == torch.bfloat16
                       else dict(rtol=3e-5, atol=3e-5))
                torch.testing.assert_close(got, want, **tol)
                torch.testing.assert_close(raw, want_raw, rtol=3e-5,
                                           atol=0.0)
                if not torch.equal(got, again):
                    raise AssertionError("gather_superpose: two calls on "
                                         "the same inputs differ")
                err = float((got - want).abs().max())
                worst = max(worst, err)
                if (m, s, d, dtype, with_scale) == (64, 504, 8070,
                                                    torch.float32, False):
                    main_err["gather_superpose"] = err
                cases += 1
    return cases, worst


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
# phases 6-8: the host-path server, the cosine route, the baselines
# ---------------------------------------------------------------------------

# Section IV-A: 20 MHz, -174 dBm/Hz, P_max = 15 W; delta_t = 8 s, U(5, 15) s
CHAN = dict(bandwidth_hz=20e6, n0_dbm_hz=-174.0, p_max_watts=15.0)
SCHED = dict(delta_t=8.0, lat_lo=5.0, lat_hi=15.0, seed=1)


def _federation(dev, data, k, sizes):
    from repro_torch.data.partition import partition_noniid
    from repro_torch.data.pipeline import build_federation
    from repro_torch.fl import FLClient
    from repro_torch.models.mlp import mlp_loss
    x, y, xt, yt = data
    parts = partition_noniid(y, n_clients=k, sizes=sizes, seed=0)
    clients = [FLClient(c, mlp_loss, batch_size=32, lr=0.1, local_steps=5)
               for c in build_federation(x, y, parts)]
    test = {"x": torch.as_tensor(xt, device=dev),
            "y": torch.as_tensor(yt, device=dev).long()}
    return clients, test


def host_path(dev, data):
    """PAOTAServer at K = 100 with the paper's sizes, counter draws,
    solver="waterfill_jnp" (the fused round's), transmit model: HOST_ROUNDS
    rounds without and HOST_ROUNDS with use_kernel, the launch counters set
    to 0 just before each run and read just after. Over the first
    PARITY_ROUNDS rounds both runs agree with FusedPAOTA on the same
    CounterDraws at the reference's fused-vs-host tolerance."""
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.data.partition import PAPER_SIZES
    from repro_torch.fl import FusedPAOTA, PAOTAConfig, PAOTAServer
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    from repro_torch.models.mlp import init_mlp_params, mlp_accuracy
    clients, test = _federation(dev, data, 100, PAPER_SIZES)
    fused = FusedPAOTA(init_mlp_params(0), clients, ChannelConfig(**CHAN),
                       SchedulerConfig(n_clients=100, **SCHED),
                       PAOTAConfig(transmit="model", seed=0), device=dev)
    fused.advance(PARITY_ROUNDS)
    fused_vec = fused.global_vec
    del fused
    out = {}
    for use_kernel in (False, True):
        srv = PAOTAServer(
            init_mlp_params(0), clients, ChannelConfig(**CHAN),
            SchedulerConfig(n_clients=100, rng="counter", **SCHED),
            PAOTAConfig(solver="waterfill_jnp", use_kernel=use_kernel,
                        rng="counter", transmit="model", seed=0),
            device=dev)
        acc0 = float(mlp_accuracy(srv.global_params(), test))
        torch.cuda.synchronize()
        rs.launches = ac.launches = ac.aircomp_sum_launches = 0
        t0 = time.perf_counter()
        rows = [srv.round() for _ in range(PARITY_ROUNDS)]
        vec5 = srv.global_vec
        rows += [srv.round() for _ in range(HOST_ROUNDS - PARITY_ROUNDS)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = {"round_stats": rs.launches,
                    "superpose_normalize": ac.launches,
                    "aircomp_sum": ac.aircomp_sum_launches}
        acc = float(mlp_accuracy(srv.global_params(), test))
        busy = sum(r["n_participants"] > 0 for r in rows)
        agg_launches = ((launches["aircomp_sum"],
                         launches["superpose_normalize"]) if use_kernel
                        else (launches["superpose_normalize"],
                              launches["aircomp_sum"]))
        checks = {
            "finite": bool(np.isfinite(srv.global_vec).all()),
            "accuracy_rose": acc > acc0,
            "round_stats_once_per_round_with_uploaders":
                launches["round_stats"] == busy,
            "aggregation_kernel_once_per_round_with_uploaders":
                agg_launches == (busy, 0),
            "tracks_fused_over_first_rounds": bool(np.allclose(
                vec5, fused_vec, rtol=1e-4, atol=1e-5)),
        }
        rec = {"phase": "host_path", "use_kernel": use_kernel,
               "clients": 100, "rounds": HOST_ROUNDS, "solver":
               "waterfill_jnp", "rounds_with_uploaders": busy,
               "ms_per_round": (t1 - t0) * 1e3 / HOST_ROUNDS,
               "accuracy_round0": acc0, "accuracy_final": acc,
               "max_abs_diff_vs_fused_at_round_5":
                   float(np.abs(vec5 - fused_vec).max()),
               "launches": launches, "checks": checks}
        log(rec)
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"host_path use_kernel={use_kernel}: "
                                 f"failed {failed}")
        out[use_kernel] = (rec, srv)
    return out


def cosine_phase(srv):
    """cosine_similarity(use_kernel=True) on the host run's delta plane
    against use_kernel=False: one launch for the one call."""
    from repro_torch.core.power_control import cosine_similarity
    from repro_torch.kernels import cosine_sim as cs
    with torch.no_grad():
        deltas = srv._pending_models - srv._pending_starts
        gdir = srv._global - srv._prev
        torch.cuda.synchronize()
        cs.launches = 0
        got = cosine_similarity(deltas, gdir, use_kernel=True)
        torch.cuda.synchronize()
        launches = cs.launches
        want = cosine_similarity(deltas, gdir, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    rec = {"phase": "cosine", "shape": list(deltas.shape),
           "launches": launches,
           "max_abs_err_vs_plain_route": float((got - want).abs().max()),
           "cos_range": [float(got.min()), float(got.max())]}
    log(rec)
    if launches != 1:
        raise AssertionError(f"cosine: {launches} launches for one call")
    return rec


def baselines(dev, data):
    """Local SGD and COTAF at K = 100 with the paper's sizes and 50
    participants, BASELINE_ROUNDS rounds each."""
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.data.partition import PAPER_SIZES
    from repro_torch.fl import COTAFServer, LocalSGDServer, SyncConfig
    from repro_torch.models.mlp import init_mlp_params, mlp_accuracy
    for name, cls in (("local_sgd", LocalSGDServer), ("cotaf", COTAFServer)):
        clients, test = _federation(dev, data, 100, PAPER_SIZES)
        args = (init_mlp_params(0), clients,
                SchedulerConfig(n_clients=100, **SCHED),
                SyncConfig(n_select=50, seed=0))
        if cls is COTAFServer:
            args += (ChannelConfig(**CHAN),)
        srv = cls(*args, device=dev)
        acc0 = float(mlp_accuracy(srv.global_params(), test))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = [srv.round() for _ in range(BASELINE_ROUNDS)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc = float(mlp_accuracy(srv.global_params(), test))
        sim_per_round = rows[-1]["time"] / BASELINE_ROUNDS
        checks = {"finite": bool(np.isfinite(srv.global_vec).all()),
                  "accuracy_rose": acc > acc0,
                  "straggler_clock_exceeds_paota_period":
                      sim_per_round > SCHED["delta_t"]}
        log({"phase": "baselines", "algo": name, "clients": 100,
             "n_select": 50, "rounds": BASELINE_ROUNDS,
             "ms_per_round": (t1 - t0) * 1e3 / BASELINE_ROUNDS,
             "sim_seconds_per_round": sim_per_round,
             "accuracy_round0": acc0, "accuracy_final": acc,
             "checks": checks})
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"baselines {name}: failed {failed}")


# ---------------------------------------------------------------------------
# phases 9-11: the active cohort, its scenario run, the state plane
# ---------------------------------------------------------------------------

COHORT_VARIANTS = (
    ("uncompressed", {}),
    ("randmask_f32_ef", dict(compress="randmask", compress_ratio=1 / 16)),
    ("topk_f32_ef", dict(compress="topk", compress_ratio=1 / 16)),
    ("randmask_int8_noef", dict(compress="randmask", compress_ratio=1 / 16,
                                slot_dtype="int8", error_feedback=False)))
COHORT_SCENARIO = dict(availability="cycle", avail_period=4, avail_duty=0.5,
                       dropout_prob=0.05, responsiveness="lognormal",
                       het_steps=(1, 3, 5))


def carry_bytes(carry) -> int:
    """Bytes of every tensor the round carry holds."""
    return sum(v.numel() * v.element_size() for v in vars(carry).values()
               if isinstance(v, torch.Tensor))


def dense_carry_bytes(k: int, d: int) -> int:
    """The dense transmit='delta' carry at (K, d): the (K, d) f32 delta
    plane, two model copies and the (K,) state plane."""
    return 4 * (k * d + 2 * d) + k * (1 + 4 + 4)


def _counters() -> dict:
    """Each kernel's launch counter: (module, attribute)."""
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import gather_superpose as gs
    from repro_torch.kernels import round_stats as rs
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import swa_attention as sw
    return {"round_stats": (rs, "launches"),
            "superpose_normalize": (ac, "launches"),
            "aircomp_sum": (ac, "aircomp_sum_launches"),
            "cosine_partials": (cs, "launches"),
            "gather_superpose": (gs, "launches"),
            "ssd_chunk": (sc, "launches"),
            "swa_attention": (sw, "launches")}


COHORT_KERNELS = ("round_stats", "superpose_normalize", "gather_superpose")


def read_counters(names=None) -> dict:
    """The launch counts of the named kernels (all seven by default)."""
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()
            if names is None or k in names}


def zero_counters() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def cohort_run(dev, data, tag, variant, kw, *, warm, rounds, scenario=None):
    """FusedPAOTA(cohort_size=64) at K = 1000 with FAST_SIZES, the paper's
    MLP, transmit='delta': ``warm`` rounds, then ``rounds`` timed; the
    launch counters are set to 0 just before the warm-up and read just
    after the last round. Compressed, gather_superpose launches once per
    round and the dense sweeps never; uncompressed, the reverse."""
    from repro_torch.core import ChannelConfig, ScenarioConfig, SchedulerConfig
    from repro_torch.data.partition import FAST_SIZES
    from repro_torch.fl import FusedPAOTA, PAOTAConfig
    from repro_torch.models.mlp import init_mlp_params, mlp_accuracy
    clients, test = _federation(dev, data, COHORT_K, FAST_SIZES)
    drv = FusedPAOTA(init_mlp_params(0), clients, ChannelConfig(**CHAN),
                     SchedulerConfig(n_clients=COHORT_K, **SCHED),
                     PAOTAConfig(transmit="delta", seed=0), device=dev,
                     cohort_size=COHORT_M,
                     scenario=(None if scenario is None
                               else ScenarioConfig(**scenario)), **kw)
    acc0 = float(mlp_accuracy(drv.global_params(), test))
    torch.cuda.synchronize()
    zero_counters()
    rows = drv.advance(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows += drv.advance(rounds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counters(COHORT_KERNELS)
    acc = float(mlp_accuracy(drv.global_params(), test))
    total = warm + rounds
    want = ({"round_stats": 0, "superpose_normalize": 0,
             "gather_superpose": total} if kw else
            {"round_stats": total, "superpose_normalize": total,
             "gather_superpose": 0})
    nbytes = carry_bytes(drv._carry)
    checks = {"finite": bool(np.isfinite(drv.global_vec).all()),
              "some_uploaders": any(r["n_participants"] > 0 for r in rows),
              "at_most_m_uploaders": all(r["n_participants"] <= COHORT_M
                                         for r in rows),
              "accuracy_rose": acc > acc0,
              "launches_once_per_round": launches == want}
    rec = {"phase": tag, "variant": variant, "clients": COHORT_K,
           "cohort_size": COHORT_M, "model_dim": drv.d,
           "compress_s": drv.compress_s, "warmup_rounds": warm,
           "rounds": rounds, "ms_per_round": (t1 - t0) * 1e3 / rounds,
           "carry_bytes": nbytes,
           "dense_carry_bytes": dense_carry_bytes(COHORT_K, drv.d),
           "mean_participants": float(np.mean([r["n_participants"]
                                               for r in rows])),
           "accuracy_round0": acc0, "accuracy_final": acc,
           "launches": launches, "checks": checks}
    log(rec)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{tag} {variant}: failed {failed}")
    return rec


def state_plane(dev, slot_dtype):
    """The reference's acceptance harness (benchmarks/cohort_round_bench.py
    ``_synth_scan``) on the port's runtime: K = 10^6 clients, m = 256
    slots, d = 16384, fabricated local updates g + 1e-3 N(0, 1) keyed per
    round, the counter latency / channel / priority draws and the
    availability-cycle + dropout scenario over all K clients, randmask
    1/16 without error feedback, PLANE_ROUNDS rounds."""
    from repro_torch.core import ChannelConfig, ScenarioConfig
    from repro_torch.core.power_control import p2_constants
    from repro_torch.core.scheduler import round_tag_generator
    from repro_torch.fl.runtime import (CounterDraws, RoundCfg, RoundStreams,
                                        init_cohort_carry, scan_rounds)
    k, m, d = PLANE_K, PLANE_M, PLANE_D
    s = round(d / 16)
    chan = ChannelConfig(**CHAN)
    sc = ScenarioConfig(availability="cycle", avail_period=4,
                        avail_duty=0.5, dropout_prob=0.05)
    draws = CounterDraws(0, 0, dev, k=k, d=d, lat_lo=5.0, lat_hi=15.0,
                         chan=chan, n_samples=np.ones(1, np.int64),
                         local_steps=1, batch_size=1, scenario=sc, m=m, s=s)
    c1, c0 = p2_constants(10.0, 0.05, k, d, chan.sigma_n2)
    rcfg = RoundCfg(omega=3.0, c1=c1, c0=c0, p_max_watts=chan.p_max_watts,
                    delta_t=8.0, transmit_delta=True, cohort_size=m,
                    compress="randmask", compress_s=s, slot_dtype=slot_dtype,
                    error_feedback=False)

    def fan(g, r, ids):
        # tag 12: clear of the scheduler's draw tags (0-10)
        gen = round_tag_generator(0, r, 12, dev)
        z = torch.randn((ids.shape[0], d), generator=gen, device=dev)
        return g[None, :] + 1e-3 * z

    streams = RoundStreams(
        local_train=None, latencies=draws.latencies, channel=draws.channel,
        noise=draws.noise, scenario=draws.scenario_masks, cohort_train=fan,
        sched_priority=draws.sched_priority,
        compress_mask=draws.compress_mask,
        quant_uniform=(draws.quant_uniform if slot_dtype == "int8"
                       else None))
    with torch.no_grad():
        carry = init_cohort_carry(torch.zeros((d,), device=dev),
                                  streams=streams, k=k, m=m,
                                  keep_pending=False, rcfg=rcfg)
        nbytes = carry_bytes(carry)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        carry, outs = scan_rounds(carry, PLANE_ROUNDS, rcfg=rcfg,
                                  streams=streams)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = read_counters(COHORT_KERNELS)
    n_upl = outs["n_participants"].cpu().numpy()
    checks = {"finite": bool(torch.isfinite(carry.global_vec).all()),
              "some_uploaders": bool((n_upl > 0).any()),
              "gather_superpose_once_per_round":
                  launches == {"round_stats": 0, "superpose_normalize": 0,
                               "gather_superpose": PLANE_ROUNDS}}
    rec = {"phase": "state_plane", "slot_dtype": slot_dtype, "clients": k,
           "cohort_size": m, "model_dim": d, "compress_s": s,
           "rounds": PLANE_ROUNDS,
           "ms_per_round": (t1 - t0) * 1e3 / PLANE_ROUNDS,
           "carry_bytes": nbytes, "dense_carry_bytes":
               dense_carry_bytes(k, d),
           "mean_participants": float(n_upl.mean()),
           "global_norm": float(carry.global_vec.norm()),
           "launches": launches, "checks": checks}
    log(rec)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"state_plane {slot_dtype}: failed {failed}")
    return rec


# ---------------------------------------------------------------------------
# phases 12-15: the LM slice (mamba2-370m serving; SSD and SWA kernels)
# ---------------------------------------------------------------------------

def ssd_inputs(dev, g, q, n, p, dtype, seed):
    """The reference's sweep inputs (tests/test_kernels.py): cum a
    decreasing cumulative log-decay, B, C, xdt standard normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cum = -torch.cumsum(0.05 + 0.2 * torch.rand((g, q), generator=gen,
                                                device=dev), dim=1)
    b = torch.randn((g, q, n), generator=gen, device=dev).to(dtype)
    c = torch.randn((g, q, n), generator=gen, device=dev).to(dtype)
    xdt = torch.randn((g, q, p), generator=gen, device=dev).to(dtype)
    return cum, b, c, xdt


def ssd_grouped_inputs(dev, bz, nc, h, g, q, n, p, offset, dtype, seed):
    """Grouped SSD inputs: cum (Bz, NC, Q, H), xdt (Bz, NC, Q, H, P), and B,
    C (Bz, NC, Q, G, N), contiguous, or with ``offset`` strided views of a
    (Bz, NC*Q, offset + 2 G N) conv-output-like tensor as ``apply_mamba2``
    hands them over."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cum = -torch.cumsum(0.05 + 0.2 * torch.rand((bz, nc, q, h), generator=gen,
                                                device=dev), dim=2)
    xdt = torch.randn((bz, nc, q, h, p), generator=gen, device=dev).to(dtype)
    if offset is None:
        b, c = (torch.randn((bz, nc, q, g, n), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
    else:
        xbc = torch.randn((bz, nc * q, offset + 2 * g * n), generator=gen,
                          device=dev).to(dtype)
        b = xbc[..., offset:offset + g * n].reshape(bz, nc, q, g, n)
        c = xbc[..., offset + g * n:].reshape(bz, nc, q, g, n)
    return cum, b, c, xdt


def _check_ssd(got, again, want, dtype, what):
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else dict(rtol=2e-5, atol=2e-5))
    err = 0.0
    for a, b, w in zip(got, again, want):
        torch.testing.assert_close(a, w, **tol)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two calls on the same inputs "
                                 f"differ")
        err = max(err, float((a.float() - w.float()).abs().max()))
    return err


def ssd_parity(dev, main_err):
    """The SSD kernel against its twin: through the reference-shaped entry
    at the reference's four sweep shapes and the full-width per-head shape,
    and through the grouped entry at mamba2-370m's prefill layer (32 heads
    on one group), on strided views of a conv output, and at a ragged
    shape; f32 at the reference's 2e-5 and bf16 at 2e-2, every output, two
    calls bit-identical."""
    from repro_torch.kernels import ssd_chunk as sc
    cases, worst, errs = 0, 0.0, {}
    for g, q, n, p in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(dev, g, q, n, p, dtype, g + q + n + p)
            got = sc.ssd_intra_chunk_cuda(*args)
            again = sc.ssd_intra_chunk_cuda(*args)
            want = sc.ssd_intra_chunk_plain(*args)
            torch.cuda.synchronize()
            err = _check_ssd(got, again, want, dtype, "ssd_intra_chunk")
            if dtype == torch.float32:
                worst = max(worst, err)
            if (g, q, n, p, dtype) == SSD_MAIN + (torch.float32,):
                errs["reference_shape"] = err
            cases += 1
    for case in SSD_GROUPED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_grouped_inputs(dev, *case, dtype, sum(case[:7]))
            got = sc.ssd_intra_chunk_grouped_cuda(*args)
            again = sc.ssd_intra_chunk_grouped_cuda(*args)
            want = sc.ssd_intra_chunk_grouped_plain(*args)
            torch.cuda.synchronize()
            err = _check_ssd(got, again, want, dtype,
                             "ssd_intra_chunk_grouped")
            if dtype == torch.float32:
                worst = max(worst, err)
            if case == SSD_GROUPED + (None,) and dtype == torch.float32:
                errs["grouped_main_shape"] = err
            if case == SSD_GROUPED + (2048,) and dtype == torch.float32:
                errs["grouped_strided_views"] = err
            del args, got, again, want
            cases += 1
    main_err["ssd_chunk"] = errs["grouped_main_shape"]
    main_err["ssd_chunk_reference_shape"] = errs["reference_shape"]
    log({"phase": "ssd_parity", "cases": cases, "all_close": True,
         "bit_identical_on_repeat": True,
         "max_abs_err_at_main_shape": main_err["ssd_chunk"],
         "max_abs_err": errs, "max_abs_err_any_f32_case": worst})


def _gqa_flat(q, k, v):
    """ops.swa_attention's layout restated: the kv heads repeated over
    their query heads, (B, T, H, D) -> (B H, T, D)."""
    b, t, h, d = q.shape
    rep = h // k.shape[2]
    k, v = (torch.repeat_interleave(x, rep, dim=2) for x in (k, v))
    return [x.transpose(1, 2).reshape(b * h, x.shape[1], d).contiguous()
            for x in (q, k, v)]


def swa_inputs(dev, b, t, h, hkv, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def swa_parity(dev, main_err):
    """swa_attention against its twin: the reference's seven sweep shapes
    (windowed, full, bidirectional, ragged) and its bf16 case, then two
    attention shapes of the zoo at T = 4608, W = 4096 through
    ops.swa_attention (mixtral-8x22b's 48 query heads over 8 kv heads,
    D = 128; zamba2-7b's 32/32 heads, D = 112), at the reference's 3e-5
    (f32) and 3e-2 (bf16), two calls bit-identical. Returns the mixtral
    case's inputs and kernel output for the path phase."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    cases, worst = 0, 0.0
    for t, s, d, window, causal in SWA_SWEEP:
        gen = torch.Generator(device=dev).manual_seed(t + s + d)
        q, k, v = (torch.randn((3, n, d), generator=gen, device=dev)
                   for n in (t, s, s))
        got = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
        again = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
        want = sw.swa_attention_plain(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
        if not torch.equal(got, again):
            raise AssertionError("swa_attention: two calls differ")
        worst = max(worst, float((got - want).abs().max()))
        cases += 1
    gen = torch.Generator(device=dev).manual_seed(64)
    q, k, v = (torch.randn((2, 128, 64), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    got = sw.swa_attention_cuda(q, k, v, window=64)
    want = sw.swa_attention_plain(q, k, v, window=64)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    cases += 1
    zoo = {}
    for name, (h, hkv, d) in SWA_ZOO.items():
        q, k, v = swa_inputs(dev, 1, SWA_PARITY_T, h, hkv, d, torch.float32,
                             h + d)
        got = ops.swa_attention(q, k, v, window=SWA_WINDOW)
        again = ops.swa_attention(q, k, v, window=SWA_WINDOW)
        want = sw.swa_attention_plain(*_gqa_flat(q, k, v), window=SWA_WINDOW)
        want = want.reshape(1, h, SWA_PARITY_T, d).transpose(1, 2)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
        if not torch.equal(got, again):
            raise AssertionError(f"swa_attention {name}: two calls differ")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        zoo[name] = err
        cases += 1
        if name == "mixtral-8x22b":
            main_err["swa_attention"] = err
            path_case = (q, k, v, got)
        del want, again
    log({"phase": "swa_parity", "cases": cases, "all_close": True,
         "bit_identical_on_repeat": True, "zoo_shapes_t": SWA_PARITY_T,
         "zoo_window": SWA_WINDOW, "max_abs_err_zoo": zoo,
         "max_abs_err_any_f32_case": worst})
    return path_case


def swa_path(path_case):
    """The kernel's own entry point, ops.swa_attention, once at
    mixtral-8x22b's attention shape (no model reaches it in the
    reference): counters set to 0 just before and read just after; the
    output is the one held against the twin in swa_parity."""
    from repro_torch.kernels import ops
    q, k, v, held = path_case
    torch.cuda.synchronize()
    zero_counters()
    out = ops.swa_attention(q, k, v, window=SWA_WINDOW)
    torch.cuda.synchronize()
    launches = read_counters()
    checks = {"swa_attention_once": launches == dict(
                  {k: 0 for k in launches}, swa_attention=1),
              "equals_the_output_held_against_the_twin":
                  bool(torch.equal(out, held)),
              "finite": bool(torch.isfinite(out).all())}
    rec = {"phase": "swa_path", "shape": list(q.shape),
           "kv_heads": k.shape[2], "window": SWA_WINDOW,
           "launches": launches, "checks": checks}
    log(rec)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"swa_path: failed {failed}")
    return rec


def _prefill_decode(model, prompt, steps, cache):
    """The serving path as the CLI drives it (steps.prefill, the hand-off,
    steps.serve), timed, with the ssd counts of the prefill and of the
    decode read apart."""
    from repro_torch.launch.steps import prefill, serve
    b, t = prompt.shape
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    logits, caches = prefill(model, {"tokens": prompt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill_counts = read_counters()
    state = model.cache_from_prefill(caches, b, cache, t)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    toks = [tok]
    zero_counters()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for i in range(steps):
        tok, state = serve(model, toks[-1], state, t + i)
        toks.append(tok)
        if i == 0:
            torch.cuda.synchronize()
            t3 = time.perf_counter()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    decode_counts = read_counters()
    return {"logits": logits, "tokens": torch.cat(toks, 1),
            "prefill_ms": (t1 - t0) * 1e3,
            "first_decode_ms": (t3 - t2) * 1e3,
            "decode_ms_per_step": (t4 - t3) * 1e3 / (steps - 1),
            "prefill_counts": prefill_counts,
            "decode_counts": decode_counts}


def layer_stage_times(model, dev):
    """ms of one Mamba2 layer and of its two projections at the main run's
    shapes (CUDA events, L2 flushed before each call): the prefill layer
    over 8 x 1,024 tokens, the decode layer over 8 tokens."""
    cfg = model.cfg
    layer = model.layers[0]
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    u = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=gen,
                    device=dev)
    y = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_inner), generator=gen,
                    device=dev)
    u1, y1 = u[:, :1].contiguous(), y[:, :1].contiguous()
    state = {k: v[0] for k, v in model.init_decode_state(
        LM_BATCH, LM_CACHE).items()}
    w_in, w_out = layer.mamba["in_proj"], layer.mamba["out_proj"]
    with torch.inference_mode():
        return {"prefill_layer": time_ms(lambda: layer(u, cfg), flush),
                "prefill_in_proj": time_ms(lambda: u @ w_in, flush),
                "prefill_out_proj": time_ms(lambda: y @ w_out, flush),
                "decode_layer": time_ms(lambda: layer.decode(u1, state, cfg),
                                        flush),
                "decode_in_proj": time_ms(lambda: u1 @ w_in, flush),
                "decode_out_proj": time_ms(lambda: y1 @ w_out, flush)}


def lm_serve(dev):
    """mamba2-370m at full width (48 layers, d_model 1024, 32 SSM heads of
    P = 64, N = 128, chunk 256, vocab 50,280), f32, random init from a
    seeded generator: a warm-up prefill, then batch 8 through the prefill
    step on a 1,024-token random prompt (4 chunks) and 64 greedy decode
    steps; prefill -> decode continuity against a 1,024-token forward; a
    300-token prompt (the chunk padding)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step, forward, init_model, \
        param_count
    cfg = get_config("mamba2-370m")
    torch.cuda.synchronize()
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(2024)

    def prompt(t):
        return torch.randint(0, cfg.vocab_size, (LM_BATCH, t), generator=gen,
                             device=dev, dtype=torch.int32)

    warm = _prefill_decode(model, prompt(LM_PROMPT), 2, LM_CACHE)
    run = _prefill_decode(model, prompt(LM_PROMPT), LM_STEPS, LM_CACHE)

    # (b) continuity: 5 teacher-forced decode steps after a prefill of
    # T - 5 tokens against the T-token forward
    toks = prompt(LM_PROMPT)
    t_pre = LM_PROMPT - CONT_STEPS
    with torch.inference_mode():
        full, _, _ = forward(model, {"tokens": toks})
        ref_rows = full[:, t_pre - 1:].clone()
        del full
        last, caches = prefill(model, {"tokens": toks[:, :t_pre]})
        state = model.cache_from_prefill(caches, LM_BATCH, LM_CACHE, t_pre)
        outs = []
        for i in range(CONT_STEPS):
            lg, state = decode_step(model, toks[:, t_pre + i:t_pre + i + 1],
                                    state, t_pre + i)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, 1)
    cont_err = float((dec - ref_rows[:, 1:]).abs().max())
    pre_err = float((last[:, -1] - ref_rows[:, 0]).abs().max())
    continuity = (bool(torch.allclose(dec, ref_rows[:, 1:], rtol=3e-3,
                                      atol=3e-3))
                  and bool(torch.allclose(last[:, -1], ref_rows[:, 0],
                                          rtol=3e-3, atol=3e-3)))

    # (c) a prompt that is not a multiple of the chunk
    short = _prefill_decode(model, prompt(LM_SHORT), 2, LM_CACHE)
    peak = torch.cuda.max_memory_allocated()
    stages = layer_stage_times(model, dev)

    zero = {k: 0 for k in run["prefill_counts"]}
    per_prefill = dict(zero, ssd_chunk=cfg.num_layers)
    checks = {
        "ssd_once_per_layer_per_prefill": all(
            r["prefill_counts"] == per_prefill for r in (warm, run, short)),
        "no_kernel_in_decode": all(r["decode_counts"] == zero
                                   for r in (warm, run, short)),
        "continuity_3e-3": continuity,
        "finite_logits": all(bool(torch.isfinite(r["logits"]).all())
                             for r in (warm, run, short)),
        "tokens_in_vocab": bool(((run["tokens"] >= 0)
                                 & (run["tokens"] < cfg.vocab_size)).all()),
    }
    n_params = param_count(model)
    rec = {"phase": "lm_serve", "arch": cfg.name, "dtype": cfg.param_dtype,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": n_params, "init_s": init_s, "batch": LM_BATCH,
           "prompt_len": LM_PROMPT, "decode_steps": LM_STEPS,
           "prefill_ms": run["prefill_ms"],
           "prefill_ms_first_call": warm["prefill_ms"],
           "prefill_tok_per_s": LM_BATCH * LM_PROMPT * 1e3 / run["prefill_ms"],
           "first_decode_ms": run["first_decode_ms"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_per_s": LM_BATCH * 1e3 / run["decode_ms_per_step"],
           "short_prompt_len": LM_SHORT,
           "short_prefill_ms": short["prefill_ms"],
           "continuity_prefill_len": t_pre,
           "continuity_max_abs_diff": cont_err,
           "continuity_prefill_logits_max_abs_diff": pre_err,
           "mem_at_start_mb": mem_at_start / 2**20,
           "peak_mem_mb": peak / 2**20,
           "layer_stage_ms": stages,
           "sampled_ids": run["tokens"][:2, :10].tolist(),
           "launches": {"prefill": run["prefill_counts"]["ssd_chunk"],
                        "decode": run["decode_counts"]["ssd_chunk"],
                        "prefill_all": run["prefill_counts"],
                        "decode_all": run["decode_counts"]},
           "checks": checks}
    log(rec)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"lm_serve: failed {failed}")
    return rec


# ---------------------------------------------------------------------------
# phase 12: kernel times
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
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import round_stats as rs
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB
    # the method's own floor: one one-element kernel, timed the same way;
    # and two, what one more small node on the stream (a memset) adds
    one = torch.zeros((1,), device=dev)
    floor = time_ms(lambda: one.add_(1.0), flush)
    floor2 = time_ms(lambda: (one.add_(1.0), one.add_(1.0)), flush)
    log({"phase": "kernel_time", "kernel": "launch_floor",
         "what": "one.add_(1) on a one-element tensor", "ms": floor,
         "two_ops_ms": floor2})
    out = {"launch_floor": floor}
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
        bp = p * m
        nbytes = 4 * (k * d + k + 2 * d)
        nops = 2 * k * d + k + 2 * d
        out[("aircomp_sum", k)] = {
            "ms": time_ms(lambda: ac.aircomp_sum_cuda(x, bp, noise), flush),
            "plain_ms": time_ms(lambda: ac.aircomp_sum_plain(x, bp, noise),
                                flush),
            "yardstick_ms": time_ms(lambda: torch.mv(x.t(), bp), flush),
            "yardstick": "torch.mv(x.t(), bp) (partial: the contraction "
                         "only)",
            "bound_ms": max(nbytes / bw, nops / flops) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= nops / flops
            else "operations"}
        nbytes = 4 * (k * d + d + 2 * k)
        nops = 4 * k * d
        out[("cosine_partials", k)] = {
            "ms": time_ms(lambda: cs.cosine_partials_cuda(x, g), flush),
            "plain_ms": time_ms(lambda: cs.cosine_partials_plain(x, g),
                                flush),
            "yardstick_ms": time_ms(lambda: x @ g, flush),
            "yardstick": "x @ g (partial: the dot column only)",
            "bound_ms": max(nbytes / bw, nops / flops) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= nops / flops
            else "operations"}
    for key, rec in out.items():
        if key == "launch_floor":
            continue
        name, k = key
        log({"phase": "kernel_time", "kernel": name, "shape": [k, 8070],
             "dtype": "float32", **rec})
    from repro_torch.kernels import gather_superpose as gs
    for m, s, d in GS_SHAPES:
        v, idx, bp, noise, _ = gs_inputs(dev, m, s, d, torch.float32, False,
                                         m + d)
        idx64 = idx.long().reshape(-1)
        nbytes = m * s * (4 + 4) + 8 * m + 8 * d
        nops = 2 * m * s + m + 2 * d
        rec = {
            "ms": time_ms(lambda: gs.gather_superpose_cuda(
                v, idx, bp, noise, d=d), flush),
            "plain_ms": time_ms(lambda: gs.gather_superpose_plain(
                v, idx, bp, noise, d=d), flush),
            "yardstick_ms": time_ms(lambda: torch.zeros(
                (d,), device=dev).index_add_(
                    0, idx64, (bp[:, None] * v.float()).reshape(-1)), flush),
            "yardstick": "torch.zeros(d).index_add_(0, idx, (w[:, None] * "
                         "v).flatten()) (partial: no noise, no varsigma)",
            "bound_ms": max(nbytes / bw, nops / flops) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= nops / flops
            else "operations"}
        out[("gather_superpose", (m, s, d))] = rec
        log({"phase": "kernel_time", "kernel": "gather_superpose",
             "shape": [m, s, d], "dtype": "float32", **rec})
    return out


def _bound(nbytes, nops, bw, flops):
    return {"bound_ms": max(nbytes / bw, nops / flops) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= nops / flops
            else "operations"}


def ssd_work(cells, h, g, q, n, p, itemsize):
    """The SSD intra-chunk part's work as its inputs need it: (operations
    on the CUDA cores, operations of the state product on the tensor
    cores, bytes). C B^T once per group and cell over the causal half
    (i >= j), the decay product and scores @ xdt per head over the same
    half, b * tail and the state product per head; each input read once,
    each output written once."""
    pairs = q * (q + 1) // 2
    cuda_ops = cells * (g * pairs * 2 * n + h * (pairs * (2 * p + 1) + q * n))
    mma_ops = cells * h * 2 * q * n * p
    nbytes = (4 * cells * q * h + itemsize * cells * (2 * q * g * n
                                                      + 2 * q * h * p)
              + 4 * cells * h * (p * n + 1))
    return cuda_ops, mma_ops, nbytes


def ssd_bounds(cuda_ops, mma_ops, nbytes, bw, flops, tf32):
    """bound_ms for the kernel's split (the y products as f32 FMAs on the
    CUDA cores, the state product in three TF32 passes), beside the all-f32
    CUDA-core and the all-3xTF32 readings."""
    bytes_ms = nbytes / bw * 1e3
    ops_ms = (cuda_ops / flops + 3 * mma_ops / tf32) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms_kernel_split": ops_ms,
            "ops_ms_all_f32_cuda_cores": (cuda_ops + mma_ops) / flops * 1e3,
            "ops_ms_all_3xtf32": 3 * (cuda_ops + mma_ops) / tf32 * 1e3,
            "flops_counted": cuda_ops + mma_ops,
            "flops_tensor_cores": mma_ops, "bytes_counted": nbytes}


def lm_kernel_times(dev, bw, flops, tf32):
    """The LM slice's kernels at their main shapes, f32: the SSD kernel at
    mamba2-370m's prefill layer through the grouped entry (on strided views
    of a conv output, as the model calls it) and at the reference's
    per-head (G, Q, N, P) = (1024, 256, 128, 64); swa_attention at
    T = 8192, W = 4096 with mixtral-8x22b's 48 heads of D = 128 (the GQA
    repeat done once, outside the timing). Attention operations are the
    (query, key) pairs inside the band, 4 D each; bytes: each input read
    once, each output written once."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import swa_attention as sw
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    out = {}
    bz, nc, h, g, q, n, p = SSD_GROUPED
    cum, b, c, xdt = ssd_grouped_inputs(dev, *SSD_GROUPED, 2048,
                                        torch.float32, 1)
    cg = c.permute(0, 1, 3, 2, 4).reshape(bz * nc * g, q, n)
    bgt = b.permute(0, 1, 3, 4, 2).reshape(bz * nc * g, n, q)
    grouped = {
        "ms": time_ms(lambda: sc.ssd_intra_chunk_grouped_cuda(cum, b, c, xdt),
                      flush),
        "plain_ms": time_ms(lambda: sc.ssd_intra_chunk_grouped_plain(
            cum, b, c, xdt), flush),
        "library_ms": None,
        "yardstick_ms": time_ms(lambda: torch.bmm(cg, bgt), flush),
        "yardstick": "torch.bmm(C, B^T) per group (partial: the full (Q, Q) "
                     "scores only)",
        **ssd_bounds(*ssd_work(bz * nc, h, g, q, n, p, 4), bw, flops, tf32)}
    log({"phase": "kernel_time", "kernel": "ssd_chunk", "entry": "grouped",
         "shape": {"Bz": bz, "NC": nc, "H": h, "G": g, "Q": q, "N": n,
                   "P": p}, "dtype": "float32", **grouped})
    del cum, b, c, xdt, cg, bgt

    gr, q, n, p = SSD_MAIN
    cum, b, c, xdt = ssd_inputs(dev, gr, q, n, p, torch.float32, 1)
    bt = b.transpose(1, 2)
    per_head = {
        "ms": time_ms(lambda: sc.ssd_intra_chunk_cuda(cum, b, c, xdt),
                      flush),
        "plain_ms": time_ms(lambda: sc.ssd_intra_chunk_plain(cum, b, c, xdt),
                            flush),
        "library_ms": None,
        "yardstick_ms": time_ms(lambda: torch.bmm(c, bt), flush),
        "yardstick": "torch.bmm(C, B^T) (partial: the full (Q, Q) scores "
                     "only)",
        **ssd_bounds(*ssd_work(gr, 1, 1, q, n, p, 4), bw, flops, tf32)}
    log({"phase": "kernel_time", "kernel": "ssd_chunk",
         "entry": "reference-shaped", "shape": list(SSD_MAIN),
         "dtype": "float32", **per_head})
    del cum, b, c, xdt, bt
    out["ssd_chunk"] = dict(grouped, reference_shape=per_head)

    h, hkv, d = SWA_ZOO["mixtral-8x22b"]
    t = SWA_TIME_T
    qf, kf, vf = _gqa_flat(*swa_inputs(dev, 1, t, h, hkv, d, torch.float32,
                                       3))
    mask = sw.band_mask(t, t, SWA_WINDOW, True, dev)
    nops = 4 * d * h * int(mask.sum())
    nbytes = 4 * 4 * h * t * d
    q4, k4, v4 = (x.view(1, h, t, d) for x in (qf, kf, vf))

    def library():
        # the fused memory-efficient backend, which takes a mask and f32;
        # sdpa_kernel makes the call raise if that backend is refused
        # rather than fall back to the unfused math path
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    got = sw.swa_attention_cuda(qf, kf, vf, window=SWA_WINDOW)
    err = float((got - sw.swa_attention_plain(qf, kf, vf,
                                              window=SWA_WINDOW)).abs().max())
    lib_err = float((library().view(h, t, d) - got).abs().max())
    del got
    out["swa_attention"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: sw.swa_attention_cuda(qf, kf, vf,
                                                    window=SWA_WINDOW),
                      flush),
        "plain_ms": time_ms(lambda: sw.swa_attention_plain(
            qf, kf, vf, window=SWA_WINDOW), flush),
        "library_ms": time_ms(library, flush),
        "library": "F.scaled_dot_product_attention(q, k, v, attn_mask=band) "
                   "on (1, H, T, D)",
        "library_backend": "EFFICIENT_ATTENTION",
        "library_max_abs_diff_vs_kernel": lib_err,
        "flops_counted": nops, "bytes_counted": nbytes,
        **_bound(nbytes, nops, bw, flops)}
    log({"phase": "kernel_time", "kernel": "swa_attention",
         "shape": [h, t, d], "kv_heads": hkv, "window": SWA_WINDOW,
         "dtype": "float32", **out["swa_attention"]})
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
    bw, flops, tf32 = card_rates(name)
    full_f32_matmul()
    log({"phase": "environment", "nvidia_smi": smi, "device": name,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "tf32": [torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32],
         "hbm_bytes_per_s": bw, "f32_flops": flops, "tf32_flops": tf32})

    # 2. build the kernels' sources from the checkout, in parallel
    seconds = build.build_all()
    log({"phase": "build", "sources": list(build.SOURCES),
         "seconds": seconds, "arch": "sm_90a"})

    # 3. kernel parity on the card
    main_err = parity(dev)

    # 4. the fused round at the paper's size, both transmit modes
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

    # 6-8. the host-path server (both aggregation routes), the cosine
    # route on its delta plane, the synchronous baselines
    host = host_path(dev, data)
    for use_kernel, (rec, _) in host.items():
        by_path[f"host_path use_kernel={use_kernel}"] = rec["launches"]
    launches["aircomp_sum"] = host[True][0]["launches"]["aircomp_sum"]
    cos = cosine_phase(host[True][1])
    launches["cosine_partials"] = cos["launches"]
    by_path["cosine"] = {"cosine_partials": cos["launches"]}
    del host
    baselines(dev, data)

    # 9-11. the active cohort (four payload variants), the same under the
    # scenario simulator, and the million-client state plane
    gs_launches = 0
    for variant, kw in COHORT_VARIANTS:
        rec = cohort_run(dev, data, "cohort_path", variant, kw,
                         warm=COHORT_WARM, rounds=COHORT_ROUNDS)
        by_path[f"cohort_path {variant}"] = rec["launches"]
        gs_launches += rec["launches"]["gather_superpose"]
    rec = cohort_run(dev, data, "cohort_scenario", "randmask_f32_ef",
                     COHORT_VARIANTS[1][1], warm=0, rounds=SCENARIO_ROUNDS,
                     scenario=COHORT_SCENARIO)
    by_path["cohort_scenario"] = rec["launches"]
    gs_launches += rec["launches"]["gather_superpose"]
    for slot_dtype in ("float32", "int8"):
        rec = state_plane(dev, slot_dtype)
        by_path[f"state_plane {slot_dtype}"] = rec["launches"]
        gs_launches += rec["launches"]["gather_superpose"]
    launches["gather_superpose"] = gs_launches

    # 12-15. the LM slice: both kernels against their twins, the SWA
    # kernel's own entry point, mamba2-370m serving at full width
    ssd_parity(dev, main_err)
    swa = swa_path(swa_parity(dev, main_err))
    by_path["swa_path"] = swa["launches"]
    launches["swa_attention"] = swa["launches"]["swa_attention"]
    lm = lm_serve(dev)
    by_path["lm_serve prefill"] = lm["launches"]["prefill_all"]
    by_path["lm_serve decode"] = lm["launches"]["decode_all"]
    launches["ssd_chunk"] = lm["launches"]["prefill"]

    # 16. kernel and stage times
    times = kernel_times(dev, bw, flops)
    stage_times(drv_main,
                torch.empty(64 * 2**20, dtype=torch.float32, device=dev))
    lm_times = lm_kernel_times(dev, bw, flops, tf32)

    sources = {"round_stats": ("round_stats+payload",
                               "src/repro_torch/csrc/round_stats.cu",
                               "src/repro/kernels/round_stats.py:112"),
               "superpose_normalize": ("superpose_normalize",
                                       "src/repro_torch/csrc/aircomp_sum.cu",
                                       "src/repro/kernels/aircomp_sum.py:119"),
               "aircomp_sum": ("aircomp_sum",
                               "src/repro_torch/csrc/aircomp_sum.cu",
                               "src/repro/kernels/aircomp_sum.py:56"),
               "cosine_partials": ("cosine_partials",
                                   "src/repro_torch/csrc/round_stats.cu",
                                   "src/repro/kernels/cosine_sim.py:42"),
               "gather_superpose": ("gather_superpose",
                                    "src/repro_torch/csrc/gather_superpose.cu",
                                    "src/repro/kernels/aircomp_sum.py:370")}
    kernels = []
    for kname, (tkey, source, replaces) in sources.items():
        shape = GS_SHAPES[0] if kname == "gather_superpose" else (100, 8070)
        t = times[(tkey, shape if kname == "gather_superpose" else 100)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "launches_by_path": {p: v[kname] for p, v in by_path.items()
                                 if kname in v},
            "max_abs_err": main_err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "yardstick_ms": t["yardstick_ms"], "yardstick": t["yardstick"],
            "launch_floor_ms": times["launch_floor"],
            "shape": list(shape), "dtype": "float32"})
    lm_rows = {"ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                             "src/repro/kernels/ssd_chunk.py:58",
                             dict(zip("Bz NC H G Q N P".split(),
                                      SSD_GROUPED))),
               "swa_attention": ("src/repro_torch/csrc/swa_attention.cu",
                                 "src/repro/kernels/swa_attention.py:92",
                                 [SWA_ZOO["mixtral-8x22b"][0], SWA_TIME_T,
                                  SWA_ZOO["mixtral-8x22b"][2]])}
    for kname, (source, replaces, shape) in lm_rows.items():
        t = lm_times[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "launches_by_path": {p: v[kname] for p, v in by_path.items()
                                 if kname in v},
            "max_abs_err": t.get("max_abs_err", main_err[kname]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "yardstick_ms": t.get("yardstick_ms"),
            "yardstick": t.get("yardstick"), "shape": shape,
            "dtype": "float32"})
        if "reference_shape" in t:
            ref = t["reference_shape"]
            kernels[-1]["reference_shape"] = {
                "shape": list(SSD_MAIN), "max_abs_err": main_err.get(
                    "ssd_chunk_reference_shape"),
                **{k: ref[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "yardstick_ms")}}
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
