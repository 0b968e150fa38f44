#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/csrc`` with nvcc (into ``build/repro_torch``), holds each
kernel against its plain-torch twin on the card, and drives the port's
paths at the paper's size (K = 100 clients, the 784-10-10-10 MLP):

- the fused PAOTA round through ``FusedPAOTA.advance`` (100 rounds per
  transmit mode, and K = 1000);
- every knob of the fused round: the pytree carry (``params_mode=
  "pytree"``, both sweeps launched once per leaf, 100 rounds per mode, held
  against the raveled run), the bf16 carry (``pending_dtype="bfloat16"``,
  100 rounds per mode), fault injection with screening, the norm fence and
  the divergence rollback (``faults``), and checkpoint/resume bit for bit
  (dense f32, dense bf16 with rollback, the compressed int8 cohort);
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
  B and C, the attention kernel's branch cases in f32 and bf16,
  mixtral-8x22b's and zamba2-7b's attention at T = 4608, W = 4096), the
  attention kernel through its own entry point
  ``ops.swa_attention``, and mamba2-370m serving at full width (48
  layers, f32, random weights from a seed): batch 8, a 1,024-token prompt
  through the prefill step, 64 greedy decode steps, prefill -> decode
  continuity against a full forward, and a 300-token prompt.

- the paper's harness (``repro_torch.bench``) at the reference's paper
  scale (``REPRO_BENCH_FULL=1``: K = 100, 120 rounds, 50 synchronous
  participants): the Theorem-1 bound, Table I with PAOTA on the host path
  and on the fused round, Fig. 3 at both noise levels and the fixed-beta
  ablation, each sweep launched once per PAOTA round and every algorithm
  ending above its round-0 accuracy (``paper_harness``);
- the kernel, fused-round, round-perf and engine benches through
  ``python -m repro_torch.bench.run``'s entry into a temporary
  ``REPRO_BENCH_OUT``, each artifact naming the card and its power limit,
  and the differ over them (``bench_suite``).

It times the seven kernels (the two sweeps also in bf16 and as the
pytree carry's six per-leaf launches) with ``repro_torch.bench.timing``,
the benches' own method, and prints one JSON record per phase. Its last
three lines are the ``kernels`` record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; without a GPU, or outside a checkout, it exits 2 at once.

It imports torch, numpy and the port only.
"""
from __future__ import annotations

import csv
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if (SRC / "repro_torch").is_dir():
    # one timing method for the benches and this script
    sys.path.insert(0, str(SRC))
    from repro_torch.bench.timing import graph_ms, l2_flush, time_ms

# data-sheet HBM bandwidth (bytes/s), f32 rate outside the tensor cores and
# dense TF32 tensor-core rate (FLOP/s) at the full power limit, matched on
# the device name in order
CARDS = (("H200", 4.8e12, 67e12, 495e12),
         ("H100 PCIe", 2.0e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 60e12, 418e12),
         ("H100", 3.35e12, 67e12, 495e12))

# the sweeps' parity shapes (K, D): odd D, D = 8070 (float2 loads), D % 8 ==
# 0 (16-byte loads), several passes per row in sweep 1 (K = 1, D = 20000),
# several rounds of row loads per warp in sweep 2 (K = 1000, D = 511),
# the pytree carry's leaf widths of the paper's MLP (10, 100, 7840), and
# the round-perf bench's hidden-64 MLP at its K = 16 and 1000: the raveled
# plane (D = 55,050) and its pytree carry's leaf widths
ROUND_PERF_WIDTHS = (55050, 50176, 4096, 640, 64, 10)
PARITY_SHAPES = ((1, 1), (3, 511), (64, 8191), (100, 8070), (100, 8192),
                 (1000, 8070), (1, 20000), (1000, 511), (100, 10),
                 (100, 100), (100, 7840)) + tuple(
    (k, d) for k in (16, 1000) for d in ROUND_PERF_WIDTHS)
MAIN_ROUNDS = 100
SCALE_ROUNDS = 20
HOST_ROUNDS = 30
PARITY_ROUNDS = 5
BASELINE_ROUNDS = 30
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
# swa_attention: the reference's sweep (T, S, D, W, causal) with the
# kernels bench's shape, and two attention shapes of the zoo (H, Hkv, D)
# with their window
SWA_SWEEP = ((128, 128, 64, None, True), (200, 200, 32, 64, True),
             (256, 256, 64, 96, True), (256, 256, 128, 128, True),
             (64, 64, 16, None, False), (96, 96, 64, 32, True),
             (130, 130, 64, 64, True), (512, 512, 64, 128, True))
# the tensor-core kernel's branches (T, S, D, W, causal), f32 and bf16
# (the same list as tests/test_torch_cuda.py's SWA_BRANCHES: change both):
# every instance's head dim (16 to 256; 33 and 40 with pitches that are no
# 16-byte multiple), ragged T and S both ways, windows around the 64-key
# tile and beyond T, a query tile of edge tiles only (T = 64, no window),
# rows with no key (W = 0; T > S with a window), causal off with a window
SWA_BRANCHES = ((64, 64, 16, 1, True), (129, 200, 33, 63, True),
                (200, 129, 40, 64, True), (257, 257, 64, 65, True),
                (300, 280, 112, 1000, True), (190, 300, 128, 64, False),
                (64, 64, 128, None, True), (170, 100, 64, 20, True),
                (65, 70, 32, 0, True), (200, 180, 256, 63, True),
                (130, 130, 200, 65, False), (100, 100, 96, None, False))
SWA_ZOO = {"mixtral-8x22b": (48, 8, 128), "zamba2-7b": (32, 32, 112)}
# the timed rows: (zoo entry, dtype)
SWA_TIMED = (("mixtral-8x22b", torch.float32), ("zamba2-7b", torch.float32),
             ("mixtral-8x22b", torch.bfloat16))
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

def run_path(dev, data, *, k, sizes, transmit, rounds, tag, leaves=1,
             compare=None, **knobs):
    """Drive FusedPAOTA.advance for ``rounds`` rounds with the launch
    counters set to 0 just before and read just after; ``knobs`` go to
    FusedPAOTA, and each sweep must launch ``leaves`` times a round (6 for
    the MLP's pytree carry). ``compare(drv)`` returns more (fields,
    checks) for the record."""
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
                     device=dev, **knobs)
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
        "launches_equal_rounds": all(v == leaves * rounds
                                     for v in launches.values()),
    }
    if compare is not None:
        fields, more = compare(drv)
        checks.update(more)
    else:
        fields = {}
    rec = {"phase": tag, "transmit": transmit, "clients": k, **knobs,
           "model_dim": drv.d, "rounds": rounds,
           "ms_per_round": (t2 - t0) * 1e3 / rounds,
           "ms_per_round_after_warmup": (t2 - t1) * 1e3 / (rounds - warm),
           "accuracy_round0": acc0, "accuracy_final": acc,
           "mean_participants": float(np.mean([r["n_participants"]
                                               for r in rows])),
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
           "launches": launches, **fields, "checks": checks}
    log(rec)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{tag} transmit={transmit}: failed {failed}")
    return rec, drv


# ---------------------------------------------------------------------------
# phases 5b-5e: the pytree carry, the bf16 carry, faults, checkpoint/resume
# ---------------------------------------------------------------------------

def plane_bytes(carry) -> int:
    """Bytes of the carry's (K, ...) planes: pending (when carried) and the
    deltas, every leaf of them."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size()
               for plane in (carry.pending, carry.deltas) if plane is not None
               for t in tree_leaves(plane))


# pytree against raveled after MAIN_ROUNDS rounds: model transmit at
# tests/test_pytree_round.py:125's tolerance; delta transmit at the fused
# round's standing delta tolerance (ROADMAP Queue 3 item 1: its water-filling
# carries sqrt(eps_f32) into the weights, and the leaf-order sums of sweep 1
# move it)
PYTREE_TOL = {"model": dict(rtol=1e-4, atol=1e-5),
              "delta": dict(rtol=1e-4, atol=5e-5)}


def carry_parity(drv) -> dict:
    """Both sweeps on the run's own carry, leaf by leaf, at the shapes and
    dtypes the path gave them: the CUDA kernel against its plain version
    on the same inputs (sweep 1 on the deltas with and without the
    payload and on the direction w_g - w_g^prev; sweep 2 on the payload
    with seeded powers, a half mask and the leaf's slice of one noise
    draw), at ``_tol``. Returns each kernel's largest error; raises when
    one disagrees. These launches come after the path's counters were
    read."""
    from repro_torch.core.aggregation import stacked_tree_noise
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    from repro_torch.tree import tree_leaves, tree_map
    carry = drv._carry
    payload = carry.deltas if carry.pending is None else carry.pending
    gdir = tree_map(lambda a, b: a - b, carry.global_vec, carry.prev_global)
    d_leaves, p_leaves = tree_leaves(carry.deltas), tree_leaves(payload)
    k, dev = d_leaves[0].shape[0], d_leaves[0].device
    gen = torch.Generator(device=dev).manual_seed(5)
    p = 0.1 + 15.0 * torch.rand((k,), generator=gen, device=dev)
    m = (torch.rand((k,), generator=gen, device=dev) < 0.5).float()
    noise = 2.8e-7 * torch.randn((drv.d,), generator=gen, device=dev)
    err = {"round_stats": 0.0, "superpose_normalize": 0.0}
    for dl, pl, gl, nz in zip(d_leaves, p_leaves, tree_leaves(gdir),
                              stacked_tree_noise(noise, p_leaves)):
        rows, prow, g = dl.reshape(k, -1), pl.reshape(k, -1), gl.reshape(-1)
        tol = _tol(rows.dtype)
        for pay in (None, prow):
            got, got_g = rs.round_stats_cuda(rows, g, pay)
            want, want_g = rs.round_stats_plain(rows, g, pay)
            torch.testing.assert_close(got, want, **tol)
            torch.testing.assert_close(got_g, want_g, rtol=3e-5, atol=0.0)
            err["round_stats"] = max(err["round_stats"],
                                     float((got - want).abs().max()))
        got, raw = ac.superpose_normalize_cuda(prow, p, m, nz.reshape(-1))
        want, want_raw = ac.superpose_normalize_plain(prow, p, m,
                                                      nz.reshape(-1))
        torch.testing.assert_close(got, want, **(
            tol if rows.dtype == torch.bfloat16
            else dict(rtol=3e-5, atol=3e-5)))
        torch.testing.assert_close(raw, want_raw, rtol=3e-5, atol=0.0)
        err["superpose_normalize"] = max(err["superpose_normalize"],
                                         float((got - want).abs().max()))
    return err


def pytree_path(dev, data, main_recs):
    """params_mode="pytree" at the paper's size, MAIN_ROUNDS per transmit
    mode: each sweep launches six times a round (once per leaf of the
    MLP), the accuracy rises, the final global stays within PYTREE_TOL
    of the raveled main path's on the same counter draws, and each
    leaf's kernels agree with their plain versions on the run's own
    carry (``carry_parity``)."""
    from repro_torch.data.partition import PAPER_SIZES
    out = {}
    for transmit in ("model", "delta"):
        raveled = main_recs[transmit]["global"]

        def compare(drv):
            g = drv.global_vec
            return ({"max_abs_diff_vs_raveled":
                     float(np.abs(g - raveled).max()),
                     "accuracy_raveled":
                         main_recs[transmit]["accuracy_final"],
                     "max_abs_err": carry_parity(drv)},
                    {"within_raveled_tolerance": bool(np.allclose(
                        g, raveled, **PYTREE_TOL[transmit])),
                     "carry_is_six_leaves": all(
                         len(plane) == 3 for plane in (
                             drv._carry.deltas, drv._carry.global_vec))})
        rec, _ = run_path(dev, data, k=100, sizes=PAPER_SIZES,
                          transmit=transmit, rounds=MAIN_ROUNDS,
                          tag="pytree_path", leaves=6, compare=compare,
                          params_mode="pytree")
        out[transmit] = rec
    return out


def bf16_carry(dev, data, main_recs):
    """pending_dtype="bfloat16" at the paper's size, MAIN_ROUNDS per
    transmit mode: the (K, d) planes in bf16 at half their f32 bytes, both
    sweeps once a round on them, the accuracy above round 0's (printed
    beside the f32 run's), and the kernels agree with their plain
    versions on the run's own bf16 planes (``carry_parity``)."""
    from repro_torch.data.partition import PAPER_SIZES
    out = {}
    for transmit in ("model", "delta"):
        def compare(drv):
            carry = drv._carry
            planes = [p for p in (carry.pending, carry.deltas)
                      if p is not None]
            nbytes = plane_bytes(carry)
            f32_bytes = 4 * sum(p.numel() for p in planes)
            return ({"plane_bytes": nbytes, "plane_bytes_f32": f32_bytes,
                     "carry_bytes": carry_bytes(carry),
                     "accuracy_f32": main_recs[transmit]["accuracy_final"],
                     "max_abs_diff_vs_f32": float(np.abs(
                         drv.global_vec - main_recs[transmit]["global"]
                     ).max()),
                     "max_abs_err": carry_parity(drv)},
                    {"planes_bf16": all(p.dtype == torch.bfloat16
                                        for p in planes),
                     "planes_at_half_the_f32_bytes": 2 * nbytes == f32_bytes,
                     "global_f32": carry.global_vec.dtype == torch.float32})
        rec, _ = run_path(dev, data, k=100, sizes=PAPER_SIZES,
                          transmit=transmit, rounds=MAIN_ROUNDS,
                          tag="bf16_carry", compare=compare,
                          pending_dtype="bfloat16")
        out[transmit] = rec
    return out


FAULT_ROUNDS = 30


def _paper_driver(dev, clients, transmit, **kw):
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.fl import FusedPAOTA, PAOTAConfig
    from repro_torch.models.mlp import init_mlp_params
    return FusedPAOTA(init_mlp_params(0), clients, ChannelConfig(**CHAN),
                      SchedulerConfig(n_clients=len(clients), **SCHED),
                      PAOTAConfig(transmit=transmit, seed=0), device=dev,
                      **kw)


# broadcast rounds whose local models the blowup scales 100x: every upload
# of round 4 was trained in round 3 or 4 (a session lasts at most two
# periods), so the power cap (7) cannot dilute it with clean rows
BLOWUP_ROUNDS = (3, 4)


def _blowup(drv, scale=100.0):
    """Scale every local model trained at a broadcast round of
    BLOWUP_ROUNDS by ``scale``."""
    base = drv._streams

    def train(g, r):
        tr = base.local_train(g, r)
        return tr * scale if r in BLOWUP_ROUNDS else tr
    drv._streams = base._replace(local_train=train)


def faults(dev, data):
    """Fault injection at the paper's size (K = 100), FAULT_ROUNDS rounds
    each, stepped one round at a time so that every round's injected rows
    can be counted: a NaN storm unscreened (the aggregate guard holds w_g
    in every round with a NaN upload) and screened (n_screened equals the
    non-finite rows among the round's uploaders; the run stays finite and
    learns), Byzantine uploads without and with the norm fence, deep
    fades, and the divergence rollback on a one-round blowup."""
    from repro_torch.core.scheduler import FaultConfig
    from repro_torch.data.partition import PAPER_SIZES
    from repro_torch.models.mlp import mlp_accuracy
    clients, test = _federation(dev, data, 100, PAPER_SIZES)

    def acc(drv):
        return float(mlp_accuracy(drv.global_params(), test))

    def run(tag, transmit, blowup=False, **kw):
        drv = _paper_driver(dev, clients, transmit, **kw)
        if blowup:
            _blowup(drv)
        acc0 = acc(drv)
        zero_counters()
        per_round = []
        t0 = time.perf_counter()
        for _ in range(FAULT_ROUNDS):
            carry = drv._ensure_carry()
            bad = ~torch.isfinite(carry.deltas).all(dim=1)
            t, before = carry.t, drv.global_vec
            row = drv.advance(1)[0]
            upl = drv._carry.model_round == t + 1   # this round's uploaders
            per_round.append((int((bad & upl).sum()), int(row["n_screened"]),
                              not np.array_equal(before, drv.global_vec)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FAULT_ROUNDS
        g = drv.global_vec
        rec = {"phase": "faults", "case": tag, "transmit": transmit,
               "clients": 100, "rounds": FAULT_ROUNDS, "ms_per_round": ms,
               "accuracy_round0": acc0, "accuracy_final": acc(drv),
               "finite": bool(np.isfinite(g).all()),
               "global_norm": float(np.linalg.norm(g)),
               "injected_among_uploaders": sum(p[0] for p in per_round),
               "n_screened": sum(p[1] for p in per_round),
               "rounds_updated": sum(p[2] for p in per_round),
               "rolled_back": [r["round"] for r in drv.history
                               if r["rolled_back"]],
               "launches": read_counters(("round_stats",
                                          "superpose_normalize"))}
        return rec, drv, per_round

    recs, checks = [], {}
    storm = FaultConfig(nan_frac=0.3, start=1)
    rec, _, per = run("nan_storm_unscreened", "delta", faults=storm)
    recs.append(rec)
    checks["unscreened_storm_injects"] = rec["injected_among_uploaders"] > 0
    checks["unscreened_storm_holds_w_g"] = rec["finite"] and all(
        not changed for n_bad, _, changed in per if n_bad)
    rec, _, per = run("nan_storm_screened", "delta", faults=storm,
                      screen=True)
    recs.append(rec)
    checks["screened_storm_counts_injected_rows"] = all(
        n_bad == n_scr for n_bad, n_scr, _ in per)
    checks["screened_storm_screens"] = rec["n_screened"] > 0
    checks["screened_storm_finite_and_learns"] = (
        rec["finite"] and rec["accuracy_final"] > rec["accuracy_round0"])
    rec, clean, _ = run("clean_model", "model")
    recs.append(rec)
    g_clean, n_clean = clean.global_vec, rec["global_norm"]
    byz = FaultConfig(byzantine_frac=0.3, byzantine_scale=-50.0, start=1)
    rec, drv, _ = run("byzantine_unscreened", "model", faults=byz)
    dev_unscr = float(np.linalg.norm(drv.global_vec - g_clean))
    rec["deviation_from_clean"] = dev_unscr
    recs.append(rec)
    rec, drv, _ = run("byzantine_fenced", "model", faults=byz, screen=True,
                      screen_max_norm=BYZ_FENCE)
    dev_fence = float(np.linalg.norm(drv.global_vec - g_clean))
    rec.update(deviation_from_clean=dev_fence, screen_max_norm=BYZ_FENCE)
    recs.append(rec)
    checks["fence_screens"] = rec["n_screened"] > 0
    checks["fence_contains"] = rec["finite"] and dev_fence < 0.5 * dev_unscr
    rec, _, _ = run("deep_fade", "delta",
                    faults=FaultConfig(deep_fade_frac=0.3))
    recs.append(rec)
    checks["deep_fade_finite_and_learns"] = (
        rec["finite"] and rec["accuracy_final"] > rec["accuracy_round0"])
    rec, _, _ = run("blowup_unguarded", "model", blowup=True)
    recs.append(rec)
    n_bare = rec["global_norm"]
    checks["blowup_corrupts"] = rec["finite"] and n_bare > 5.0 * n_clean
    rec, _, _ = run("blowup_rollback", "model", blowup=True,
                    divergence_factor=4.0)
    recs.append(rec)
    # the blown rows upload at rounds 3 to 5
    checks["rollback_fires_on_the_blowup_only"] = bool(
        rec["rolled_back"]) and set(rec["rolled_back"]) <= {3, 4, 5}
    checks["rollback_recovers"] = (
        rec["finite"] and rec["global_norm"] < 0.1 * n_bare
        and rec["accuracy_final"] > rec["accuracy_round0"])
    for r in recs:
        log(r)
    log({"phase": "faults", "checks": checks})
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"faults: failed {failed}")
    return recs


# the Byzantine norm fence (model transmit): clean payload rows carry the
# model, whose norm stays near ||w_g^0|| (about 8 for init_mlp_params(0));
# a Byzantine row w_g - 50 (w - w_g) lands well above it
BYZ_FENCE = 12.0


def checkpoint_resume(dev, data, tmpdir):
    """10 straight rounds against 5 + save + a new FusedPAOTA + restore +
    5, bit for bit on the card: the dense f32 carry (model transmit), the
    dense bf16 carry with rollback (delta), and the compressed cohort with
    int8 slots at K = 1000 (m = 64, top-k 1/16)."""
    from repro_torch.data.partition import FAST_SIZES, PAPER_SIZES
    cases = (("dense_f32", 100, PAPER_SIZES, "model", {}),
             ("dense_bf16_rollback", 100, PAPER_SIZES, "delta",
              dict(pending_dtype="bfloat16", divergence_factor=4.0)),
             ("cohort_topk_int8", COHORT_K, FAST_SIZES, "delta",
              dict(cohort_size=COHORT_M, compress="topk",
                   compress_ratio=1 / 16, slot_dtype="int8")))
    checks = {}
    for name, k, sizes, transmit, kw in cases:
        clients, _ = _federation(dev, data, k, sizes)
        full = _paper_driver(dev, clients, transmit, **kw)
        full.advance(10)
        part = _paper_driver(dev, clients, transmit, **kw)
        part.advance(5)
        path = str(Path(tmpdir) / f"{name}.npz")
        t0 = time.perf_counter()
        part.save_checkpoint(path)
        t_save = time.perf_counter() - t0
        res = _paper_driver(dev, clients, transmit, **kw)
        t0 = time.perf_counter()
        step = res.restore_checkpoint(path)
        t_load = time.perf_counter() - t0
        res.advance(5)
        same_rows = all(
            a.keys() == b.keys() and all(
                np.array_equal(a[key], b[key], equal_nan=True) for key in a)
            for a, b in zip(full.history, res.history))
        checks[name] = bool(step == 5 and np.array_equal(
            full.global_vec, res.global_vec) and same_rows
            and len(res.history) == 10)
        log({"phase": "checkpoint_resume", "case": name, "clients": k,
             "transmit": transmit, **kw, "file_bytes":
                 Path(path).stat().st_size,
             "save_s": t_save, "restore_s": t_load,
             "bit_identical": checks[name]})
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"checkpoint_resume: failed {failed}")


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
    (windowed, full, bidirectional, ragged), the kernels bench's (T = 512,
    W = 128) and the reference's bf16 case, then two
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
    branches = {}
    for dtype, tol in ((torch.float32, 3e-5), (torch.bfloat16, 3e-2)):
        errs = []
        for t, s, d, window, causal in SWA_BRANCHES:
            gen = torch.Generator(device=dev).manual_seed(t + s + d)
            q, k, v = (torch.randn((3, n, d), generator=gen,
                                   device=dev).to(dtype) for n in (t, s, s))
            got = sw.swa_attention_cuda(q, k, v, window=window,
                                        causal=causal)
            again = sw.swa_attention_cuda(q, k, v, window=window,
                                          causal=causal)
            want = sw.swa_attention_plain(q, k, v, window=window,
                                          causal=causal)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            if not torch.equal(got, again):
                raise AssertionError(f"swa_attention {dtype}: two calls "
                                     f"differ at {(t, s, d, window)}")
            errs.append(float((got.float() - want.float()).abs().max()))
            cases += 1
        # k and v one element off 16-byte alignment: staged by plain loads
        ks, vs = (torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:]
                  .view(x.shape) for x in (k, v))
        ks.copy_(k)
        vs.copy_(v)
        if not torch.equal(sw.swa_attention_cuda(q, ks, vs, window=window,
                                                 causal=causal), got):
            raise AssertionError(f"swa_attention {dtype}: unaligned planes "
                                 f"differ")
        cases += 1
        branches[str(dtype).split(".")[-1]] = max(errs)
    worst = max(worst, branches["float32"])
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
         "max_abs_err_branches": branches,
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
    flush = l2_flush(dev)
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
# phases 16-17: the paper's harness and the bench suite
# ---------------------------------------------------------------------------

SWEEPS = ("round_stats", "superpose_normalize")


def _harness_run(tag, fn, trajectories):
    """Run one paper module with the sweep counters at 0, appending every
    trajectory it makes through ``common.run_algorithm`` to
    ``trajectories``. Returns (rows, PAOTA rounds run, sweep launches)."""
    from repro_torch.bench import common
    made = []
    orig = common.run_algorithm

    def recording(name, s, *args, **kw):
        rows = orig(name, s, *args, **kw)
        made.append((name, s, rows))
        return rows
    common.run_algorithm = recording
    zero_counters()
    try:
        rows = fn()
    finally:
        common.run_algorithm = orig
    launches = read_counters(SWEEPS)
    paota_rounds = sum(s.n_rounds for name, s, _ in made if name == "paota")
    for name, s, traj in made:
        trajectories.append((tag, name, s, traj))
    return rows, paota_rounds, launches


def paper_harness(dev, tmpdir):
    """The reference's paper scale (REPRO_BENCH_FULL=1: K = 100, 120
    rounds, 50 synchronous participants) on the card: the bound, Table I
    with PAOTA on the host path and on the fused round, Fig. 3 at both
    noise levels, and the fixed-beta ablation. Every PAOTA round launches
    each sweep once; every algorithm ends above its round-0 accuracy."""
    from repro_torch.bench import ablation, bound, common, fig3, table1
    from repro_torch.fl import evaluate
    from repro_torch.models.mlp import mlp_apply
    from repro_torch.tree import tree_map
    checks, by_path, trajectories = {}, {}, []
    with mock.patch.dict(os.environ, REPRO_BENCH_FULL="1",
                         REPRO_BENCH_OUT=tmpdir):
        t = time.perf_counter()
        rows = bound.run(dev)
        log({"phase": "paper_harness", "module": "bound", "rows": rows,
             "seconds": time.perf_counter() - t})
        # the fixed-beta servers are built without run_algorithm: their
        # rounds are the ablation setting's, once per variant
        s = common.BenchSetting.from_env(n_rounds=30)
        world = (s,) + common.build_world(s)
        _, _, params, (_, _, x_te, y_te) = world
        acc_init = evaluate(tree_map(lambda a: a.to(dev), params), x_te,
                            y_te, mlp_apply)["accuracy"]
        fixed = tuple(ablation.FIXED_BETA)
        runs = [("table1 host", lambda: table1.run(dev)),
                ("table1 fused", lambda: table1.run(dev, engine="fused")),
                ("fig3", lambda: fig3.run(dev)),
                ("ablation fixed beta", lambda: ablation.run_solver_ablation(
                    dev, names=fixed, world=world))]
        for tag, fn in runs:
            t = time.perf_counter()
            rows, paota_rounds, launches = _harness_run(tag, fn,
                                                        trajectories)
            if tag.startswith("ablation"):
                paota_rounds = s.n_rounds * len(fixed)
            per_round = {k: v / max(paota_rounds, 1)
                         for k, v in launches.items()}
            by_path[f"paper_harness {tag}"] = launches
            checks[f"{tag}: one launch of each sweep per PAOTA round"] = (
                paota_rounds > 0 and all(v == paota_rounds
                                         for v in launches.values()))
            rec = {"phase": "paper_harness", "module": tag,
                   "seconds": time.perf_counter() - t,
                   "ms_per_round": {r["name"]: r["us_per_call"] / 1e3
                                    for r in rows},
                   "paota_rounds": paota_rounds, "launches": launches,
                   "launches_per_paota_round": per_round, "rows": rows}
            if tag.startswith("table1"):
                with open(os.path.join(tmpdir, "table1.csv")) as f:
                    rec["table1"] = list(csv.DictReader(f))
            if tag.startswith("ablation"):
                accs = {r["name"]: float(r["derived"].split("=")[1])
                        for r in rows}
                rec["accuracy"] = accs
                rec["accuracy_initial_params"] = acc_init
                for variant, acc in accs.items():
                    checks[f"{variant}: final accuracy above the initial "
                           f"params'"] = acc > acc_init
            log(rec)
    for tag, algo, s, traj in trajectories:
        first, last = traj[0], traj[-1]
        key = f"{tag} {algo} n0={s.n0_dbm_hz:g}"
        log({"phase": "paper_harness", "trajectory": key,
             "engine": s.engine if algo == "paota" else "batched",
             "clients": s.n_clients, "rounds": s.n_rounds,
             "accuracy_round0": first["accuracy"],
             "accuracy_final": last["accuracy"], "loss_final": last["loss"],
             "sim_time_final": last["time"], "wall_s": last["wall_s"]})
        checks[f"{key}: final accuracy above round 0's"] = (
            last["accuracy"] > first["accuracy"]
            and np.isfinite(last["loss"]))
    failed = [c for c, ok in checks.items() if not ok]
    log({"phase": "paper_harness", "checks": len(checks), "failed": failed})
    if failed:
        raise AssertionError(f"paper_harness: failed {failed}")
    return by_path


BENCH_MODULES = ("kernels", "fused_round", "round_perf", "fl_engine")


def bench_suite(dev, tmpdir, smi, name):
    """``python -m repro_torch.bench.run`` of the kernel, fused-round,
    round-perf and engine benches into a temporary REPRO_BENCH_OUT: each
    artifact parses and names the card and its power limit, and the
    differ passes the artifacts against themselves. Then each kernels-bench
    kernel against its twin on the bench's own inputs, at 3e-5 (these
    launches come after the counters were read); the round-perf planes and
    leaves are in PARITY_SHAPES."""
    from repro_torch.bench import diff, kernels_bench, run
    t = time.perf_counter()
    zero_counters()
    with mock.patch.dict(os.environ, REPRO_BENCH_OUT=tmpdir):
        os.environ.pop("REPRO_BENCH_FULL", None)
        run.main(list(BENCH_MODULES))
    launches = read_counters()
    checks, rows = {}, {}
    for mod in BENCH_MODULES:
        with open(os.path.join(tmpdir, f"BENCH_{mod}.json")) as f:
            art = json.load(f)
        rows[mod] = art["rows"]
        checks[f"{mod}: names the card"] = (
            art["backend"] == "cuda" and art["device_name"] == name
            and art["nvidia_smi"] == smi and art["device_count"] >= 1)
        checks[f"{mod}: finite rows"] = bool(art["rows"]) and all(
            np.isfinite(r["us_per_call"]) for r in art["rows"])
    checks["kernels: a kernel row beside each twin row"] = sorted(
        r["name"].replace("_ref", "") for r in rows["kernels"]
        if "_ref" in r["name"]) == sorted(
        r["name"] for r in rows["kernels"] if "_ref" not in r["name"])
    checks["diff of the artifacts against themselves exits 0"] = diff.main(
        ["--baseline", tmpdir, "--current", tmpdir]) == 0
    errs = {}
    for _, kname, twin, kernel, args, _ in kernels_bench.cases(dev):
        got = torch.utils._pytree.tree_leaves(kernel(*args))
        want = torch.utils._pytree.tree_leaves(twin(*args))
        torch.cuda.synchronize()
        errs[kname] = max(float((a - w).abs().max())
                          for a, w in zip(got, want))
        checks[f"kernels: {kname} agrees with its twin"] = all(
            torch.allclose(a, w, rtol=3e-5, atol=3e-5)
            for a, w in zip(got, want))
    failed = [c for c, ok in checks.items() if not ok]
    log({"phase": "bench_suite", "modules": list(BENCH_MODULES),
         "seconds": time.perf_counter() - t, "rows": rows,
         "launches": launches, "kernels_max_abs_err": errs,
         "checks": len(checks), "failed": failed})
    if failed:
        raise AssertionError(f"bench_suite: failed {failed}")
    return launches


# ---------------------------------------------------------------------------
# phase 18: kernel times
# ---------------------------------------------------------------------------

def kernel_times(dev, bw, flops):
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import cosine_sim as cs
    from repro_torch.kernels import round_stats as rs
    flush = l2_flush(dev)
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


MLP_LEAVES = {"l1": {"w": (784, 10), "b": (10,)},
              "l2": {"w": (10, 10), "b": (10,)},
              "l3": {"w": (10, 10), "b": (10,)}}


def _sweep_work(widths, k, itemsize, planes):
    """(bytes, operations) of sweep 1 over rows of the given widths: each
    plane and g read once, the (k, planes + 1) stats and gn2 written."""
    nbytes = sum(itemsize * planes * k * w + 4 * (w + k * (planes + 1) + 1)
                 for w in widths)
    nops = sum(2 * k * w * (planes + 1) + 2 * w for w in widths)
    return nbytes, nops


def _superpose_work(widths, k, itemsize):
    """(bytes, operations) of sweep 2 over payload rows of the given
    widths: the plane, powers, mask and noise read once, the aggregate
    and varsigma written."""
    nbytes = sum(itemsize * k * w + 4 * (2 * k + 2 * w + 1) for w in widths)
    nops = sum(2 * k * w + k + 2 * w for w in widths)
    return nbytes, nops


def carry_sweep_times(dev, bw, flops, flush):
    """The sweeps as the bf16 and pytree carries launch them, at K x D =
    100 x 8070 and 1000 x 8070: both sweeps on bf16 planes (yardsticks
    ``x @ g`` and ``mv`` in bf16 on the same plane), and one round's six
    per-leaf launches of each sweep on the MLP's leaves (f32), timed as
    the six launches alone and through the round's entry (``ops
    .round_stats`` / ``paota_aggregate_stacked``), each as issued from the
    host (``ms``, ``entry_ms``: the Python wrappers outlast the flush, so
    the host's issue time shows) and replayed from a CUDA graph
    (``graph_ms``, ``entry_graph_ms``: the device's time), beside the
    bound of the same bytes, the plain versions' time (``plain_ms``) and
    the largest difference from them on the same inputs
    (``max_abs_err``, held at ``_tol``)."""
    from repro_torch.core.aggregation import paota_aggregate_stacked
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import ops
    from repro_torch.kernels import round_stats as rs
    from repro_torch.tree import tree_leaves, tree_map
    d = 8070
    out = {}
    for k in (100, 1000):
        gen = torch.Generator(device=dev).manual_seed(7 * k)
        x = torch.randn((k, d), generator=gen, device=dev).to(torch.bfloat16)
        pay = torch.randn((k, d), generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn((d,), generator=gen, device=dev)
        g16 = g.to(torch.bfloat16)
        p = 15.0 * torch.rand((k,), generator=gen, device=dev)
        m = (torch.rand((k,), generator=gen, device=dev) < 0.5).float()
        bp16 = (p * m).to(torch.bfloat16)
        noise = 2.8e-7 * torch.randn((d,), generator=gen, device=dev)
        for payload in (pay, None):
            name = "round_stats" + ("" if payload is None else "+payload")
            nbytes, nops = _sweep_work((d,), k, 2, 1 if payload is None
                                       else 2)
            got, want = (fn(x, g, payload)[0] for fn in (
                rs.round_stats_cuda, rs.round_stats_plain))
            torch.testing.assert_close(got, want, **_tol(torch.bfloat16))
            out[(name, "bf16", k)] = {
                "max_abs_err": float((got - want).abs().max()),
                "ms": time_ms(lambda: rs.round_stats_cuda(x, g, payload),
                              flush),
                "plain_ms": time_ms(lambda: rs.round_stats_plain(
                    x, g, payload), flush),
                "yardstick_ms": time_ms(lambda: x @ g16, flush),
                "yardstick": "x @ g in bf16 (partial: the dot column only)",
                **_bound(nbytes, nops, bw, flops)}
        nbytes, nops = _superpose_work((d,), k, 2)
        got, want = (fn(x, p, m, noise)[0] for fn in (
            ac.superpose_normalize_cuda, ac.superpose_normalize_plain))
        torch.testing.assert_close(got, want, **_tol(torch.bfloat16))
        out[("superpose_normalize", "bf16", k)] = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": time_ms(lambda: ac.superpose_normalize_cuda(x, p, m, noise),
                          flush),
            "plain_ms": time_ms(lambda: ac.superpose_normalize_plain(
                x, p, m, noise), flush),
            "yardstick_ms": time_ms(lambda: torch.mv(x.t(), bp16), flush),
            "yardstick": "torch.mv(x.t(), bp) in bf16 (partial: the "
                         "contraction only)",
            **_bound(nbytes, nops, bw, flops)}
        # one round of the pytree carry: six leaves, each its own tensor
        tree = {layer: {n: torch.randn((k,) + shape, generator=gen,
                                       device=dev)
                        for n, shape in leaves.items()}
                for layer, leaves in MLP_LEAVES.items()}
        ptree = tree_map(lambda t: t * 0.5, tree)
        gtree = tree_map(lambda t: t[0].clone(), tree)
        rows = [(l.reshape(k, -1), pl.reshape(k, -1), gl.reshape(-1))
                for l, pl, gl in zip(tree_leaves(tree), tree_leaves(ptree),
                                     tree_leaves(gtree))]
        widths = [r[0].shape[1] for r in rows]
        for with_payload in (True, False):
            name = "round_stats" + ("+payload" if with_payload else "")
            nbytes, nops = _sweep_work(widths, k, 4,
                                       2 if with_payload else 1)

            def six(fn=rs.round_stats_cuda):
                return [fn(dl, gl, pl if with_payload else None)[0]
                        for dl, pl, gl in rows]
            def entry():
                ops.round_stats(tree, gtree, ptree if with_payload
                                else None)
            err = 0.0
            for got, want in zip(six(), six(rs.round_stats_plain)):
                torch.testing.assert_close(got, want, **_tol(torch.float32))
                err = max(err, float((got - want).abs().max()))
            out[(name, "pytree", k)] = {
                "leaves": widths, "max_abs_err": err,
                "ms": time_ms(six, flush),
                "plain_ms": time_ms(lambda: six(rs.round_stats_plain),
                                    flush),
                "graph_ms": graph_ms(six, flush),
                "entry_ms": time_ms(entry, flush),
                "entry_graph_ms": graph_ms(entry, flush),
                **_bound(nbytes, nops, bw, flops)}
        nbytes, nops = _superpose_work(widths, k, 4)
        offs = np.cumsum([0] + widths)
        pieces = [noise[a:b] for a, b in zip(offs[:-1], offs[1:])]

        def six_sp(fn=ac.superpose_normalize_cuda):
            return [fn(pl, p, m, nz)[0] for (_, pl, _), nz in zip(rows,
                                                                  pieces)]
        def entry_sp():
            paota_aggregate_stacked(ptree, p, m, noise)
        err = 0.0
        for got, want in zip(six_sp(), six_sp(ac.superpose_normalize_plain)):
            torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
            err = max(err, float((got - want).abs().max()))
        out[("superpose_normalize", "pytree", k)] = {
            "leaves": widths, "max_abs_err": err,
            "ms": time_ms(six_sp, flush),
            "plain_ms": time_ms(
                lambda: six_sp(ac.superpose_normalize_plain), flush),
            "graph_ms": graph_ms(six_sp, flush),
            "entry_ms": time_ms(entry_sp, flush),
            "entry_graph_ms": graph_ms(entry_sp, flush),
            **_bound(nbytes, nops, bw, flops)}
    for (name, layout, k), rec in out.items():
        log({"phase": "kernel_time", "kernel": name, "shape": [k, d],
             "layout": layout, "dtype": ("bfloat16" if layout == "bf16"
                                         else "float32"), **rec})
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
    per-head (G, Q, N, P) = (1024, 256, 128, 64); swa_attention in the rows
    of SWA_TIMED (swa_time)."""
    from repro_torch.kernels import ssd_chunk as sc
    flush = l2_flush(dev)
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

    out["swa_attention"] = [swa_time(dev, name, dtype, flush, bw, flops,
                                     tf32)
                            for name, dtype in SWA_TIMED]
    return out


def swa_time(dev, name, dtype, flush, bw, flops, tf32):
    """swa_attention at T = 8192, W = 4096 with a zoo entry's query heads
    (the GQA repeat done once, outside the timing), beside its twin and SDPA
    on the efficient backend. Operations are the (query, key) pairs inside
    the band, 4 D each; bytes: each input read once, each output written
    once. Bounds: the operations in f32 on the CUDA cores, and the kernel's
    passes on the tensor cores (f32: three TF32 passes of both products;
    bf16: one pass of Q K^T and two of P V at the bf16 rate, twice TF32's on
    every card of CARDS). bound_ms is the fastest f32-accurate form on the
    card: for f32 inputs three TF32 passes of each product, for bf16 one
    pass of each at the bf16 rate. Raises where the kernel is off the twin:
    f32 by more than 3e-5; bf16 by more than half a bf16 step of the twin's
    f32 value (2^-8 of it) plus 1e-4, far under a typical output (about
    0.025 here), where the twin's 3e-2 would pass any answer."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import swa_attention as sw
    h, hkv, d = SWA_ZOO[name]
    t = SWA_TIME_T
    qf, kf, vf = _gqa_flat(*swa_inputs(dev, 1, t, h, hkv, d, dtype, 3))
    mask = sw.band_mask(t, t, SWA_WINDOW, True, dev)
    pairs = h * int(mask.sum())
    nops = 4 * d * pairs
    nbytes = qf.element_size() * 4 * h * t * d
    bf16 = 2 * tf32
    bytes_ms = nbytes / bw * 1e3
    cuda_ms = nops / flops * 1e3
    if dtype == torch.float32:
        tensor_ms = 3 * nops / tf32 * 1e3
        bound = _bound(nbytes, 3 * nops, bw, tf32)
    else:
        tensor_ms = (2 * d * pairs + 2 * 2 * d * pairs) / bf16 * 1e3
        bound = _bound(nbytes, nops, bw, bf16)
    q4, k4, v4 = (x.view(1, h, t, d) for x in (qf, kf, vf))

    def library():
        # the fused memory-efficient backend, which takes a mask and f32;
        # sdpa_kernel makes the call raise if that backend is refused
        # rather than fall back to the unfused math path
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    got = sw.swa_attention_cuda(qf, kf, vf, window=SWA_WINDOW).float()
    # the twin in f32 on the same inputs: rounded to q's dtype, it is
    # swa_attention_plain(qf, kf, vf)
    want = sw.swa_attention_plain(qf.float(), kf.float(), vf.float(),
                                  window=SWA_WINDOW)
    err = float((got - want.to(dtype).float()).abs().max())
    off = (got - want).abs()
    if dtype != torch.float32:
        off.sub_(2.0 ** -8 * want.abs())
    limit = 3e-5 if dtype == torch.float32 else 1e-4
    excess = float(off.max())
    if excess > limit:
        raise AssertionError(f"swa_attention {name} {dtype}: {excess} off "
                             f"the twin (limit {limit})")
    lib_err = float((library().view(h, t, d).float() - got).abs().max())
    del got, want, off
    rec = {
        "model": name, "shape": [h, t, d], "kv_heads": hkv,
        "window": SWA_WINDOW, "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "max_off_twin_beyond_rounding": excess,
        "off_twin_limit": limit,
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
        "flops_counted": nops, "bytes_counted": nbytes, "exps_counted": pairs,
        "bytes_ms": bytes_ms, "bound_cuda_cores_ms": max(bytes_ms, cuda_ms),
        "bound_tensor_cores_ms": max(bytes_ms, tensor_ms), **bound}
    log({"phase": "kernel_time", "kernel": "swa_attention", **rec})
    return rec


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


def no_host_sync(drv, tag="main_path") -> None:
    """Three more rounds of a driver with torch's sync debug mode set to
    error: a round must read nothing back to the host between stages (the
    one copy per advance comes after scan_rounds)."""
    from repro_torch.fl.runtime import scan_rounds
    drv._ensure_carry()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            drv._carry, _ = scan_rounds(drv._carry, 3, rcfg=drv._rcfg,
                                        streams=drv._streams)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log({"phase": "no_host_sync", "driver": tag, "rounds": 3, "ok": True})


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda is not available; this smoke needs "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.bench.common import nvidia_smi_line
    from repro_torch.data.partition import FAST_SIZES, PAPER_SIZES
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.device import full_f32_matmul
    from repro_torch.kernels import build

    # 1. environment
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    if smi is None:
        raise RuntimeError("nvidia-smi did not report the card's name and "
                           "power limit")
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
    main_recs = {}
    for transmit in ("model", "delta"):
        rec, drv = run_path(dev, data, k=100, sizes=PAPER_SIZES,
                            transmit=transmit, rounds=MAIN_ROUNDS,
                            tag="main_path")
        by_path[transmit] = rec["launches"]
        for key in launches:
            launches[key] += rec["launches"][key]
        main_recs[transmit] = {"global": drv.global_vec,
                               "accuracy_final": rec["accuracy_final"],
                               "ms_per_round_after_warmup":
                                   rec["ms_per_round_after_warmup"]}
        if transmit == "model":
            drv_main = drv

    no_host_sync(drv_main)

    # 4b-4e. every knob of the fused round: the pytree carry (six launches
    # of each sweep a round), the bf16 carry, faults with screening and
    # rollback, checkpoint/resume
    from repro_torch.core.scheduler import FaultConfig
    clients, _ = _federation(dev, data, 100, PAPER_SIZES)
    no_host_sync(_paper_driver(
        dev, clients, "model", params_mode="pytree",
        pending_dtype="bfloat16", screen=True, divergence_factor=4.0,
        faults=FaultConfig(nan_frac=0.1, byzantine_frac=0.1,
                           deep_fade_frac=0.1)),
        "pytree+bf16+faults+screen+rollback")
    del clients
    for tag, fn in (("pytree_path", pytree_path), ("bf16_carry", bf16_carry)):
        for transmit, rec in fn(dev, data, main_recs).items():
            by_path[f"{tag} {transmit}"] = rec["launches"]
            for key in launches:
                launches[key] += rec["launches"][key]
    for rec in faults(dev, data):
        by_path[f"faults {rec['case']}"] = rec["launches"]
        for key in launches:
            launches[key] += rec["launches"][key]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
        checkpoint_resume(dev, data, tmpdir)

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

    # 16-17. the paper's harness at paper scale, the bench suite
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
        for path, counts in paper_harness(dev, tmpdir).items():
            by_path[path] = counts
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
        by_path["bench_suite"] = bench_suite(dev, tmpdir, smi, name)

    # 18. kernel and stage times
    times = kernel_times(dev, bw, flops)
    carry_times = carry_sweep_times(dev, bw, flops, l2_flush(dev))
    stage_times(drv_main, l2_flush(dev))
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
        # the bf16 and pytree carries' launches of the sweeps (100 x 8070)
        others = [{"layout": layout, "shape": [100, 8070],
                   "dtype": "bfloat16" if layout == "bf16" else "float32",
                   **carry_times[(tkey, layout, 100)]}
                  for layout in ("bf16", "pytree")
                  if (tkey, layout, 100) in carry_times]
        if others:
            kernels[-1]["other_shapes"] = others
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
        if kname == "swa_attention":
            t, others = t[0], t[1:]
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
        if kname == "swa_attention":
            kernels[-1].update(
                bound_cuda_cores_ms=t["bound_cuda_cores_ms"],
                bound_tensor_cores_ms=t["bound_tensor_cores_ms"],
                other_shapes=[{k: o[k] for k in (
                    "model", "shape", "dtype", "max_abs_err", "ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "bound_cuda_cores_ms", "bound_tensor_cores_ms")}
                    for o in others])
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
