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
- the sharded round (``ShardedPAOTA``, ``sharded``): 4 ranks sharing
  this card over gloo (NCCL refuses two ranks on one device), spawned
  once after a probe of gloo's sum / min / max on CUDA tensors, run
  flat (K = 100 both transmit modes, K = 1000), pytree, phantom-padded
  (K = 102), grouped (2 pods x 2 at N = 1 and N = 4), TP (2 x 2) and
  with pod 1 blacked out, each against a single-process FusedPAOTA on
  the same counter draws round for round, with the reducer's calls and
  each rank's launches of sweep 1 and of the partial entry (once a leaf
  a round); the sharded active cohort (m = K at K = 100 against the
  fused dense round; m = 64 at K = 1000 uncompressed, randmask f32 and
  top-k int8, the first two against their own rerun on the plain twins),
  the compressed partial ``gather_superpose_partial`` once a round a
  rank; the million-client state plane on 4 ranks; a kill at round 5 of
  10 and a restore in fresh ranks, bit-identical, on four layouts (flat
  with faults, grouped with a dark pod, compressed int8, TP); the
  ``fl_train --engine sharded`` CLI with checkpoints and its resume;
  then both partial entries against their twins and yardsticks;
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
  continuity against a full forward, and a 300-token prompt;
- zamba2-7b serving at full width (81 Mamba2 layers and the shared
  attention block at 14 slots, 6.75 B params, f32, random weights from a
  seed; ``hybrid_serve``): batch 2, an 8,192-token prompt past the
  4,096-token window through the prefill step (each layer's SSD and each
  slot's attention on the two LM kernels), 32 greedy decode steps over a
  wrapped ring, continuity, and both kernels held against their twins on
  the inputs the model handed them;
- the dense family at full width (``dense_serve``; f32, random weights
  from seed 0): smollm-135m (batch 8 x 2,048 tokens), olmo-1b (4 x
  2,048), minicpm-2b (2 x 4,096) and granite-3-8b (8.37 B params, 2 x
  4,096), each a warm-up, the prefill step (every layer's attention on
  the attention kernel over the whole causal triangle), the hand-off, 32
  greedy decode steps, continuity, the kernel against its twin on the
  first layer's inputs on every (batch x head) row, stage times;
  granite-3-8b once more on int8 KV rings; then the serve CLI's default
  run (smollm-135m, a 512-token prompt);
- mixtral-8x22b at its published width, its depth cut to 4 of 56 layers
  (10.4 B params, f32, random weights from seed 0; ``moe_serve``): a
  warm-up, batch 2 through the prefill step on an 8,192-token prompt past
  the 4,096-token window (every layer's attention on the attention kernel,
  48 query heads over 8; the experts at the published capacity factor
  1.25), 32 greedy decode steps over the wrapped 4,096-slot ring,
  continuity after a 4,160-token prefill at the dropless capacity, the
  int8 KV rerun, the kernel against its twin on the first layer's inputs,
  stage times and bounds; then llama4-maverick-400b-a17b at its published
  width in bf16, cut to 1 of 48 layers (batch 2 x 4,096 tokens, 32
  decode steps, continuity at the bf16 tolerance where the routing
  matched, its drops and routing flips logged);
- internvl2-1b at full width (``vlm_serve``; f32, random weights from
  seed 0): batch 2 of [256 patch embeddings through the projector; 3,840
  tokens], every layer's attention (14 query heads over 2) on the
  attention kernel, 32 greedy decode steps from index 4,096, continuity
  after [patches; 1,000 tokens], the kernel against its twin on the first
  layer's inputs;
- hubert-xlarge at full width (``audio_encode``; f32, random weights from
  seed 0): 8 clips of 1,500 frames, masked at the published 0.08, through
  the bidirectional encoder (every layer's attention on the attention
  kernel with causal off and D = 80), the encoder's bidirectionality, the
  decode entry points' refusal, the kernel against its twin on the first
  layer's inputs and on one 8,192-frame clip beside SDPA. Before each
  serving phase ``free_held`` collects what earlier phases left
  unreachable on the card.
- the attention backward (``swa_attention_bwd``) against its twin at
  each attention family's in-model shapes (smollm-135m's train step,
  internvl2-1b's GQA 7, hubert-xlarge's D = 80 encoder, mixtral-shaped
  windowed rows) in f32 and bf16, each dtype timed beside SDPA's
  backward in that dtype and its bound (``swa_bwd``); then smollm-135m's
  PAOTA training at full width through
  ``launch.steps.make_paota_train_step`` (``lm_train``: f32, K = 4
  clients, 2 x 4,096 tokens a client, M = 2, 3 rounds with stragglers,
  every layer's attention forward and backward on the two kernels, one
  sweep 2 per params leaf a round, the loss finite and falling, a
  straggler's loss dropping on its own microbatches, the gradients at
  full width against the same step with the attention twin; one bf16
  round under ``runtime_config``; reduced mamba2 trained on the card; the
  train CLI's demo).
- the SSD backward (``ssd_chunk_bwd``) against its twin at mamba2-370m's
  and zamba2-7b's train shapes on views of their conv outputs, two
  groups, a ragged shape and a binding -60 clip, f32 and bf16, timed
  beside the twin and the forward against its bound (``ssd_bwd``); then
  mamba2-370m's PAOTA training at full width (``ssm_train``: as
  ``lm_train``, every layer's SSD forward and backward on the two
  kernels, the gradients against the same step with the SSD twin, a bf16
  round) and zamba2-7b's at full width with 12 of its 81 layers
  (``hybrid_train``: K = 2, 1 x 4,096 tokens a client, the SSD and the
  attention kernels in every layer and slot, the gradients against both
  twins). ``train_profile``, last, profiles a client step of
  smollm-135m and of mamba2-370m.

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

It times the seven kernels (the two sweeps also in bf16, as the pytree
carry's six per-leaf launches and at the train store's leaves), the
attention backward, the SSD backward and the sharded round's two partial
entries with ``repro_torch.bench.timing``,
the benches' own method, and prints one JSON record per phase. Its last
three lines are the ``kernels`` record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; without a GPU, or outside a checkout, it exits 2 at once.

It imports torch, numpy and the port only.
"""
from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import json
import os
import signal
import subprocess
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
# the LM train step's store at K = 4 (lm_train): smollm-135m's leaf widths
# (the tied embedding, the MLP, wq / wo, wk / wv, a norm's layers, the
# final norm)
TRAIN_LEAF_WIDTHS = (28311552, 26542080, 9953280, 3317760, 17280, 576)
PARITY_SHAPES = ((1, 1), (3, 511), (64, 8191), (100, 8070), (100, 8192),
                 (1000, 8070), (1, 20000), (1000, 511), (100, 10),
                 (100, 100), (100, 7840)) + tuple(
    (k, d) for k in (16, 1000) for d in ROUND_PERF_WIDTHS) + tuple(
    (4, d) for d in TRAIN_LEAF_WIDTHS)
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
# rows with no key (W = 0; T > S with a window), causal off with a window,
# hubert-xlarge's encoder row (D = 80 padded to 96, causal off, no window,
# a ragged T = 1,500)
SWA_BRANCHES = ((64, 64, 16, 1, True), (129, 200, 33, 63, True),
                (200, 129, 40, 64, True), (257, 257, 64, 65, True),
                (300, 280, 112, 1000, True), (190, 300, 128, 64, False),
                (64, 64, 128, None, True), (170, 100, 64, 20, True),
                (65, 70, 32, 0, True), (200, 180, 256, 63, True),
                (130, 130, 200, 65, False), (100, 100, 96, None, False),
                (1500, 1500, 80, None, False))
SWA_ZOO = {"mixtral-8x22b": (48, 8, 128), "zamba2-7b": (32, 32, 112)}
# the timed rows: (zoo entry, dtype)
SWA_TIMED = (("mixtral-8x22b", torch.float32), ("zamba2-7b", torch.float32),
             ("mixtral-8x22b", torch.bfloat16))
SWA_WINDOW, SWA_PARITY_T, SWA_TIME_T = 4096, 4608, 8192
# mamba2-370m serving: batch, prompt, decode steps, cache, short prompt,
# teacher-forced continuity steps
LM_BATCH, LM_PROMPT, LM_STEPS, LM_CACHE, LM_SHORT, CONT_STEPS = (
    8, 1024, 64, 2048, 300, 5)
# zamba2-7b serving: batch, prompt (past the 4,096-token window, so the
# decode ring wraps and the attention band cuts), decode steps, warm-up
# prompt, the continuity prefill (no multiple of the 256-token chunk), and
# the (batch x head) rows of the in-model attention check (the twin's
# (rows, T, T) logits bound its memory)
HY_BATCH, HY_PROMPT, HY_STEPS, HY_WARM, HY_CONT_PRE, HY_CHECK_ROWS = (
    2, 8192, 32, 512, 8187, 8)


T0 = time.perf_counter()


def log(record: dict) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps(dict(record, t_s=time.perf_counter() - T0)),
          flush=True)


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
        # the train step's leaves take sweep 2 only (no sweep 1 on its path)
        sweep1 = d not in TRAIN_LEAF_WIDTHS
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            pay = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            g = torch.randn((d,), generator=gen, device=dev)
            for payload in (None, pay) if sweep1 else ():
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
            if not sweep1:
                continue
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
            "swa_attention": (sw, "launches"),
            "swa_attention_bwd": (sw, "bwd_launches"),
            "ssd_chunk_bwd": (sc, "bwd_launches")}


COHORT_KERNELS = ("round_stats", "superpose_normalize", "gather_superpose")


def read_counters(names=None) -> dict:
    """The launch counts of the named kernels (all of them by default)."""
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
    """``ssd_chunk.grouped_example`` in SSD_GROUPED's order (Bz, NC, H, G,
    Q, N, P): cum, B, C (with ``offset`` strided views of a conv-output-like
    tensor, as ``apply_mamba2`` hands them over) and xdt."""
    from repro_torch.kernels import ssd_chunk as sc
    return sc.grouped_example(bz, nc, q, h, g, n, p, dtype=dtype, seed=seed,
                              offset=offset, device=dev)


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
        want = sw.swa_attention_plain(*ops.swa_layout(q, k, v),
                                      window=SWA_WINDOW)
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


def free_held(tag: str) -> dict:
    """Before a phase that needs the card's memory: collect unreachable
    objects (a reference cycle keeps its device tensors until the cyclic
    collector runs) and hand the allocator's cached blocks back; log the
    bytes live before and after and, where over 1 GiB stays live, the
    largest CUDA tensors still reachable."""
    import gc
    import warnings
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    rec = {"phase": "free_held", "before_phase": tag,
           "live_mb_before": before / 2**20, "live_mb_after": after / 2**20}
    if after > 2**30:
        with warnings.catch_warnings():
            # isinstance on some deprecated torch objects warns
            warnings.simplefilter("ignore", FutureWarning)
            held = sorted(((o.untyped_storage().nbytes(), list(o.shape),
                            str(o.dtype).split(".")[-1])
                           for o in gc.get_objects()
                           if isinstance(o, torch.Tensor) and o.is_cuda),
                          reverse=True)
        rec["largest_live_tensors"] = [
            {"mb": n / 2**20, "shape": s, "dtype": d} for n, s, d in held[:12]]
    log(rec)
    return rec


def _prefill_decode(model, prompt, steps, cache, patches=None):
    """The serving path as the CLI drives it (steps.prefill, the hand-off,
    steps.serve), timed, with the kernel counts of the prefill and of the
    decode read apart. ``patches`` (B, P, F): the vlm family's patch
    embeddings before the prompt; decode then starts at index P + T."""
    from repro_torch.launch.steps import prefill, serve
    b, t = prompt.shape
    batch = {"tokens": prompt}
    if patches is not None:
        batch["patch_embeds"] = patches
        t += patches.shape[1]
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch)
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


def continuity(model, batch, t_pre, cache, mocks=(), tol=3e-3):
    """Prefill -> decode continuity (tests/test_serving.py's contract on
    the card): the prefill step over the batch with its tokens cut to
    ``tokens[:, :t_pre]`` (vlm: after its ``patch_embeds``, P positions,
    so decode starts at index P + t_pre), its hand-off into a ring of
    ``cache`` slots, then teacher-forced decode steps over the rest of the
    tokens, against the forward over the whole batch, at rtol / atol
    ``tol`` (3e-3 in f32). ``mocks`` (``mock.patch`` objects) hold during
    the prefill only, whose launch counts are returned too, with whether
    each (row, decode step) is within ``tol``."""
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step, forward
    toks = batch["tokens"]
    b, t = toks.shape
    off = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    with torch.inference_mode():
        full, _, _ = forward(model, batch)
        ref = full[:, off + t_pre - 1:].clone()
        del full
        zero_counters()
        with contextlib.ExitStack() as stack:
            for patch in mocks:
                stack.enter_context(patch)
            last, caches = prefill(model, dict(batch,
                                               tokens=toks[:, :t_pre]))
        counts = read_counters()
        state = model.cache_from_prefill(caches, b, cache, off + t_pre)
        del caches
        outs = []
        for i in range(t_pre, t):
            lg, state = decode_step(model, toks[:, i:i + 1], state, off + i)
            outs.append(lg[:, 0])
        del state
        dec = torch.stack(outs, 1)
    close = torch.isclose(dec, ref[:, 1:], rtol=tol, atol=tol).all(-1)
    pre_ok = bool(torch.allclose(last[:, -1], ref[:, 0], rtol=tol,
                                 atol=tol))
    return {"continuity_prefill_len": off + t_pre,
            "continuity_decode_steps": t - t_pre,
            "continuity_max_abs_diff": float((dec - ref[:, 1:]).abs().max()),
            "continuity_prefill_logits_max_abs_diff": float(
                (last[:, -1] - ref[:, 0]).abs().max()),
            "continuity_tol": tol,
            "continuity_max_abs_logit": float(ref.abs().max()),
            "max_abs_diff_by_row_step": (dec - ref[:, 1:]).abs().amax(-1)
            .tolist(),
            "within_tol": pre_ok and bool(close.all()),
            "within_tol_by_row_step": close.tolist(),
            "prefill_counts": counts}


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
    from repro_torch.models import init_model, param_count
    cfg = get_config("mamba2-370m")
    free_held("lm_serve")
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
    cont = continuity(model, {"tokens": prompt(LM_PROMPT)},
                      LM_PROMPT - CONT_STEPS, LM_CACHE)

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
        "continuity_3e-3": cont["within_tol"],
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
           **{k: v for k, v in cont.items() if k.startswith("continuity")},
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


class _FirstCall:
    """A wrapper that keeps the first call's (args, kwargs, output)."""

    def __init__(self, fn):
        self.fn, self.call = fn, None

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.call is None:
            self.call = (args, kw, out)
        return out


def hybrid_bounds(cfg, b, t, ring, bw, flops, tf32):
    """The least time of zamba2's serving stages on the card, from shapes:
    f32 products at the CUDA-core rate (the projections are plain f32
    cuBLAS) with the SSD and attention kernels' own operation counts, and
    for decode the bytes each step must read: every weight once per use
    (the shared block's at each of its slots), the SSM states read and
    written, the rings read."""
    from repro_torch.models.ssm import _dims
    from repro_torch.models.transformer import n_shared_slots
    d, v, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim
    d_in, h, p, g, n, d_xbc = _dims(cfg)
    q, tok, slots = cfg.ssm_chunk, b * t, n_shared_slots(cfg)
    nc = -(-t // q)
    layer_mm = d * (2 * d_in + 2 * g * n + h) + d_in * d
    layer_w = layer_mm + cfg.conv_kernel * d_xbc + 3 * h + d_in + d
    cuda_ops, mma_ops, _ = ssd_work(b * nc, h, g, q, n, p, 4)
    attn_mm = d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) \
        + cfg.num_heads * hd * d
    mlp_mm = 3 * d * cfg.d_ff
    shared_w = attn_mm + mlp_mm + 2 * d
    pairs = cfg.num_heads * b * sum(min(i + 1, cfg.sliding_window)
                                    for i in range(t))
    ms = {
        "prefill_layer": (2 * tok * layer_mm + cuda_ops) / flops * 1e3
        + 3 * mma_ops / tf32 * 1e3,
        "prefill_shared": 2 * tok * (attn_mm + mlp_mm) / flops * 1e3
        + 3 * 4 * hd * pairs / tf32 * 1e3,
        "prefill_unembed_last": 2 * b * d * v / flops * 1e3,
        "decode_layer": 4 * (layer_w + 2 * b * h * p * n) / bw * 1e3,
        "decode_shared": 4 * (shared_w + 2 * b * ring * cfg.num_kv_heads
                              * hd) / bw * 1e3,
        "decode_unembed": 4 * d * v / bw * 1e3}
    ms["prefill"] = (cfg.num_layers * ms["prefill_layer"]
                     + slots * ms["prefill_shared"]
                     + ms["prefill_unembed_last"])
    ms["decode_step"] = (cfg.num_layers * ms["decode_layer"]
                         + slots * ms["decode_shared"] + ms["decode_unembed"])
    ms["prefill_flops_per_token"] = 2 * (cfg.num_layers * layer_mm
                                         + slots * (attn_mm + mlp_mm))
    ms["decode_bytes_per_step"] = 4 * (
        cfg.num_layers * (layer_w + 2 * b * h * p * n)
        + slots * (shared_w + 2 * b * ring * cfg.num_kv_heads * hd) + d * v)
    return ms


def hybrid_stage_times(model, dev, ring):
    """ms of zamba2's serving stages at the phase's shapes (CUDA events, L2
    flushed, the median of 3 calls after 5): one Mamba2 layer and the
    shared block (and its MLP half) over 2 x 8,192 tokens, the same in
    decode (the shared block over a full 4,096-slot ring) and the decode
    unembedding."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    flush = l2_flush(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    u = torch.randn((HY_BATCH, HY_PROMPT, cfg.d_model), generator=gen,
                    device=dev)
    u1 = u[:, :1].contiguous()
    layer, shared = model.layers[1], model.shared_attn
    with torch.inference_mode():
        state = model.init_decode_state(HY_BATCH, ring)
        one = {"ssm": state["ssm"][0], "conv": state["conv"][0]}
        cache = {k: torch.randn(r[0].shape, generator=gen, device=dev)
                 for k, r in state["shared_kv"].items()}
        del state
        return {
            "prefill_layer": time_ms(lambda: layer(u, cfg), flush, 3),
            "prefill_shared": time_ms(lambda: shared(u, cfg), flush, 3),
            "prefill_shared_mlp": time_ms(lambda: shared._ffn(u, cfg),
                                          flush, 3),
            "decode_layer": time_ms(lambda: layer.decode(u1, one, cfg),
                                    flush, 3),
            "decode_shared": time_ms(lambda: shared.decode(
                u1, cache, HY_PROMPT, cfg), flush, 3),
            "decode_unembed": time_ms(lambda: L.unembed(
                model.embedding, u1, cfg), flush, 3)}


def _f64_attention(q, k, v, window, causal=True):
    """The band's softmax attention in f64, one (T, D) row at a time."""
    from repro_torch.kernels import swa_attention as sw
    t, d = q.shape[1], q.shape[2]
    mask = sw.band_mask(t, t, window, causal, q.device)
    out = []
    for qr, kr, vr in zip(q, k, v):
        lg = (qr.double() @ kr.double().t()) / d ** 0.5
        lg.masked_fill_(~mask, float("-inf"))
        out.append(torch.softmax(lg, -1) @ vr.double())
        del lg
    return torch.stack(out)


def swa_in_model_check(dev, call, window, bw, tf32, check_rows=None,
                       causal=True):
    """swa_attention on the q, k, v a model handed ops.swa_attention (a
    ``_FirstCall``'s (args, kwargs, output); raises unless it was called
    with ``window`` and ``causal``): the kernel's output there against the
    twin at 3e-5 (f32; 3e-2 bf16) and a rerun bit for bit, on every (batch
    x head) row or, where the twin's (rows, T, T) logits would not fit
    beside the model, on ``check_rows`` rows spread evenly; both against
    the band's softmax in f64 on the checked rows; then the kernel on
    every row, the twin on the checked rows and SDPA on every row timed
    (the efficient backend forced; no mask when bidirectional with no
    window, ``is_causal`` when causal with none, the band's mask with one,
    on the repeated K/V). Bound: the band's pairs at 4 D operations in
    three TF32 passes (f32) or one bf16 pass each (bf16), or the bytes."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    (q4, k4, v4), kw, got = call
    if kw.get("window") != window or kw.get("causal", True) != causal:
        raise AssertionError(f"attention called with {kw}, expected "
                             f"window={window}, causal={causal}")
    tol = 3e-5 if q4.dtype == torch.float32 else 3e-2
    b, t, h, d = q4.shape
    flush = l2_flush(dev)
    with torch.inference_mode():
        flat = ops.swa_layout(q4, k4, v4)
        gotf = got.transpose(1, 2).reshape(b * h, t, d)
        if check_rows is None:
            rows, sub, held = "all", flat, gotf
        else:
            idx = torch.arange(0, b * h, b * h // check_rows, device=dev)
            rows, sub = idx.tolist(), [x[idx].contiguous() for x in flat]
            held = gotf[idx]
        want = sw.swa_attention_plain(*sub, window=window, causal=causal)
        err = float((held.float() - want.float()).abs().max())
        close = bool(torch.allclose(held.float(), want.float(), rtol=tol,
                                    atol=tol))
        exact = _f64_attention(*sub, window, causal)
        f64_err = {"kernel": float((held.double() - exact).abs().max()),
                   "twin": float((want.double() - exact).abs().max()),
                   "max_abs_out": float(exact.abs().max())}
        del want, exact
        rerun = bool(torch.equal(sw.swa_attention_cuda(
            *sub, window=window, causal=causal), held))
        del held
        pairs, nops, nbytes = swa_work(b * h, t, d, window,
                                       q4.element_size(), dev, causal)
        qs, ks, vs = (x.view(b, h, t, d) for x in flat)
        mask = (None if window is None
                else sw.band_mask(t, t, window, causal, dev))
        is_causal = causal and mask is None

        def library():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, is_causal=is_causal)

        lib_err = float((library().reshape(b * h, t, d).float()
                         - gotf.float()).abs().max())
        plain_ms = time_ms(lambda: sw.swa_attention_plain(
            *sub, window=window, causal=causal), flush, 10)
        if q4.dtype == torch.float32:
            bound = _bound(nbytes, 3 * nops, bw, tf32)
        else:
            bound = _bound(nbytes, nops, bw, 2 * tf32)
        return {
            "shape": [b * h, t, d], "kv_heads": k4.shape[2],
            "dtype": str(q4.dtype).split(".")[-1], "causal": causal,
            "window": window, "checked_rows": rows, "max_abs_err": err,
            "tol": tol, "within_tol": close, "rerun_bit_equal": rerun,
            "max_abs_err_vs_f64": f64_err,
            "ms": time_ms(lambda: sw.swa_attention_cuda(
                *flat, window=window, causal=causal), flush),
            "plain_ms": plain_ms if check_rows is None else None,
            "plain_ms_checked_rows": plain_ms,
            "library_ms": time_ms(library, flush, 10),
            "library": "F.scaled_dot_product_attention on (B, H, T, D), the "
                       "K/V repeated, " + ("is_causal" if is_causal
                                           else "no mask" if mask is None
                                           else "attn_mask=band")
                       + ", EFFICIENT_ATTENTION",
            "library_max_abs_diff_vs_kernel": lib_err,
            "pairs_counted": pairs, "flops_counted": nops,
            "bytes_counted": nbytes, **bound}


def hybrid_kernel_checks(dev, ssd_call, swa_call, window, bw, flops, tf32):
    """Each kernel against its twin on the inputs the model handed it in
    the continuity prefill, at 3e-5: ssd_chunk on the first layer's grouped
    inputs (the twin on all of them), swa_attention on the first shared
    slot's q, k, v in HY_CHECK_ROWS of its (batch x head) rows
    (``swa_in_model_check``); then both kernels timed there, beside the
    twin and (attention) SDPA."""
    from repro_torch.kernels import ssd_chunk as sc
    flush = l2_flush(dev)
    out = {}
    with torch.inference_mode():
        args, _, got = ssd_call
        cum, b, c, xdt = args
        want = sc.ssd_intra_chunk_grouped_plain(*args)
        err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
        close = all(bool(torch.allclose(a, w, rtol=3e-5, atol=3e-5))
                    for a, w in zip(got, want))
        del want
        bz, nc, q, h = cum.shape
        g, n, p = b.shape[3], b.shape[4], xdt.shape[4]
        out["ssd_chunk"] = {
            "shape": {"Bz": bz, "NC": nc, "H": h, "G": g, "Q": q, "N": n,
                      "P": p}, "max_abs_err": err, "within_3e-5": close,
            "ms": time_ms(lambda: sc.ssd_intra_chunk_grouped_cuda(*args),
                          flush),
            "plain_ms": time_ms(lambda: sc.ssd_intra_chunk_grouped_plain(
                *args), flush, 10),
            "library_ms": None,
            **ssd_bounds(*ssd_work(bz * nc, h, g, q, n, p, 4), bw, flops,
                         tf32)}
        del args, got, cum, b, c, xdt

    out["swa_attention"] = swa_in_model_check(
        dev, swa_call, window, bw, tf32, check_rows=HY_CHECK_ROWS)
    return out


def hybrid_serve(dev, bw, flops, tf32):
    """zamba2-7b at full width (81 Mamba2 layers, d_model 3584, 112 SSM
    heads of P = 64, N = 64, chunk 256; one shared attention + SwiGLU
    block of 32 heads, D = 112, W = 4096, d_ff 14336, before layers 0, 6,
    ..., 78; vocab 32,000, untied), f32, random init from seed 0: a
    512-token warm-up, then batch 2 through the prefill step on an
    8,192-token prompt twice (the first call builds the band plan at the
    new T; the second is the timed run) with 32 greedy decode steps after
    it over a 4,096-slot ring; continuity of 5 teacher-forced steps after
    an 8,187-token prefill against the 8,192-token forward; each kernel
    against its twin on that prefill's own inputs; stage times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import init_model, param_count
    cfg = get_config("zamba2-7b")
    cache = HY_PROMPT + HY_STEPS
    ring = min(cache, cfg.sliding_window)
    free_held("hybrid_serve")
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_mb = (torch.cuda.memory_allocated() - mem_at_start) / 2**20
    gen = torch.Generator(device=dev).manual_seed(2025)

    def prompt(t):
        return torch.randint(0, cfg.vocab_size, (HY_BATCH, t), generator=gen,
                             device=dev, dtype=torch.int32)

    warm = _prefill_decode(model, prompt(HY_WARM), 2, cache)
    first = _prefill_decode(model, prompt(HY_PROMPT), 2, cache)
    run = _prefill_decode(model, prompt(HY_PROMPT), HY_STEPS, cache)
    _, block_q, block_k = sw.tiles(cfg.head_dim)
    t0 = time.perf_counter()
    sw.band_plan(HY_PROMPT, HY_PROMPT, cfg.sliding_window, True, block_q,
                 block_k).to(dev)
    torch.cuda.synchronize()
    band_plan_ms = (time.perf_counter() - t0) * 1e3

    # continuity: 5 teacher-forced decode steps after a prefill of
    # HY_CONT_PRE tokens against the HY_PROMPT-token forward; the prefill
    # keeps the first layer's SSD inputs and the first slot's q, k, v
    ssd_cap = _FirstCall(ops.ssd_intra_chunk_grouped)
    swa_cap = _FirstCall(ops.swa_attention)
    cont = continuity(model, {"tokens": prompt(HY_PROMPT)}, HY_CONT_PRE,
                      HY_PROMPT, (
        mock.patch.object(ops, "ssd_intra_chunk_grouped", ssd_cap),
        mock.patch.object(ops, "swa_attention", swa_cap)))
    peak = torch.cuda.max_memory_allocated()
    in_model = hybrid_kernel_checks(dev, ssd_cap.call, swa_cap.call,
                                    cfg.sliding_window, bw, flops, tf32)
    del ssd_cap, swa_cap
    stages = hybrid_stage_times(model, dev, ring)
    bounds = hybrid_bounds(cfg, HY_BATCH, HY_PROMPT, ring, bw, flops, tf32)

    zero = {k: 0 for k in run["prefill_counts"]}
    per_prefill = dict(zero, ssd_chunk=cfg.num_layers,
                       swa_attention=len(range(0, cfg.num_layers,
                                               cfg.shared_attn_period)))
    checks = {
        "ssd_per_layer_swa_per_slot_per_prefill": all(
            r["prefill_counts"] == per_prefill for r in (warm, first, run)),
        "no_kernel_in_decode": all(r["decode_counts"] == zero
                                   for r in (warm, first, run)),
        "continuity_3e-3": cont["within_tol"],
        "ssd_chunk_in_model_within_3e-5": in_model["ssd_chunk"][
            "within_3e-5"],
        "swa_attention_in_model_within_3e-5": in_model["swa_attention"][
            "within_tol"],
        "swa_attention_in_model_rerun_bit_equal": in_model["swa_attention"][
            "rerun_bit_equal"],
        "finite_logits": all(bool(torch.isfinite(r["logits"]).all())
                             for r in (warm, first, run)),
        "tokens_in_vocab": bool(((run["tokens"] >= 0)
                                 & (run["tokens"] < cfg.vocab_size)).all()),
    }
    tokens = HY_BATCH * HY_PROMPT
    rec = {"phase": "hybrid_serve", "arch": cfg.name,
           "dtype": cfg.param_dtype, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "shared_slots": per_prefill[
               "swa_attention"], "window": cfg.sliding_window,
           "params": param_count(model), "init_s": init_s,
           "weights_mb": weights_mb, "batch": HY_BATCH,
           "prompt_len": HY_PROMPT, "decode_steps": HY_STEPS,
           "ring_slots": ring, "warmup_prompt_len": HY_WARM,
           "warmup_prefill_ms": warm["prefill_ms"],
           "prefill_ms": run["prefill_ms"],
           "prefill_ms_first_call_at_t": first["prefill_ms"],
           "band_plan_build_ms": band_plan_ms,
           "prefill_tok_per_s": tokens * 1e3 / run["prefill_ms"],
           "first_decode_ms": run["first_decode_ms"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_per_s": HY_BATCH * 1e3 / run["decode_ms_per_step"],
           "bound_ms": bounds,
           "prefill_share_of_bound": bounds["prefill"] / run["prefill_ms"],
           "decode_share_of_bound": bounds["decode_step"]
           / run["decode_ms_per_step"],
           "stage_ms": stages,
           **{k: v for k, v in cont.items() if k.startswith("continuity")},
           "in_model_kernels": in_model,
           "mem_at_start_mb": mem_at_start / 2**20,
           "peak_mem_mb": peak / 2**20,
           "peak_mem_above_start_mb": (peak - mem_at_start) / 2**20,
           "sampled_ids": run["tokens"][:, :10].tolist(),
           "launches": {"prefill": run["prefill_counts"],
                        "decode": run["decode_counts"]},
           "checks": checks}
    log(rec)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"hybrid_serve: failed {failed}")
    return rec


# ---------------------------------------------------------------------------
# phase 15c: the dense family's serving
# ---------------------------------------------------------------------------

# the dense family at full width: (arch, batch, prompt), prompts within
# each model's published context; decode steps after the timed prefill,
# the short warm-up prompt; the kv_quant rerun (its arch and decode steps,
# and the f32 run's top-2 margin above which its argmax must agree); the
# serve CLI's run (its default arch, smollm-135m): batch, prompt, steps
DENSE_RUNS = (("smollm-135m", 8, 2048), ("olmo-1b", 4, 2048),
              ("minicpm-2b", 2, 4096), ("granite-3-8b", 2, 4096))
DENSE_STEPS, DENSE_WARM = 32, 256
QUANT_ARCH, QUANT_STEPS, QUANT_MARGIN = "granite-3-8b", 8, 1e-2
CLI_BATCH, CLI_PROMPT, CLI_STEPS = 8, 512, 16


def dense_bounds(cfg, b, t, steps, bw, flops, tf32):
    """The least time of a dense model's serving, from shapes. Prefill:
    the projections and the MLP as f32 products at the CUDA-core rate
    (the port's are plain f32 cuBLAS), the attention's pairs over the
    causal triangle at 4 D operations in three TF32 passes (the kernel's),
    the last position's unembedding. A decode step: the bytes it must read
    at the HBM rate, every weight once (the embedding's gather aside) and
    the K/V of the positions it attends to, at the run's mean index."""
    d, hd, v = cfg.d_model, cfg.head_dim, cfg.vocab_size
    h, hkv, n = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    norm = 0 if cfg.norm == "nonparam_ln" else d
    mm = d * hd * (h + 2 * hkv) + h * hd * d + 3 * d * cfg.d_ff
    proj_flops = 2 * b * t * n * mm
    attn_flops = 4 * hd * n * h * b * t * (t + 1) // 2
    weights = n * (mm + 2 * norm) + d * v + norm
    kv = 2 * n * b * (t + (steps + 1) / 2) * hkv * hd
    ms = {"prefill_projections": proj_flops / flops * 1e3,
          "prefill_attention": 3 * attn_flops / tf32 * 1e3,
          "prefill_unembed_last": 2 * b * d * v / flops * 1e3,
          "decode_weights": 4 * weights / bw * 1e3,
          "decode_kv": 4 * kv / bw * 1e3}
    ms.update(prefill=ms["prefill_projections"] + ms["prefill_attention"]
              + ms["prefill_unembed_last"],
              decode_step=ms["decode_weights"] + ms["decode_kv"],
              prefill_projection_flops=proj_flops,
              prefill_attention_flops=attn_flops,
              decode_bytes_per_step=4 * (weights + kv))
    return ms


def dense_stage_times(model, dev, b, t):
    """ms of one dense layer's stages at the run's shapes (CUDA events, L2
    flushed, the median of 3 calls after 5): prefill over b x t tokens,
    the Q, K, V projections, RoPE on q and k, the GQA repeat with the
    (B H, T, D) copies ops.swa_attention makes, the swa_attention kernel,
    the output projection, the SwiGLU MLP (norm, MLP, residual), the whole
    layer; decode, one layer over a full t-slot ring and the unembedding
    of one token a row (none for an encoder-only config, whose attention
    is timed bidirectional)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import layers as L
    cfg = model.cfg
    block = model.layers[0]
    attn = block.attn
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    flush = l2_flush(dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    with torch.inference_mode():
        x, o = randn(b, t, cfg.d_model), randn(b, t, h * hd)
        q, k, v = randn(b, t, h, hd), randn(b, t, hkv, hd), randn(b, t, hkv,
                                                                 hd)
        flat = ops.swa_layout(q, k, v)
        pos = torch.arange(t, device=dev)
        out = {
            "prefill_qkv_proj": time_ms(lambda: [
                L.apply_dense(attn[w], x) for w in ("wq", "wk", "wv")],
                flush, 3),
            "prefill_rope": time_ms(lambda: (
                L.rope_rotate(q, pos, cfg.rope_theta),
                L.rope_rotate(k, pos, cfg.rope_theta)), flush, 3),
            "prefill_gqa_repeat_layout": time_ms(
                lambda: ops.swa_layout(q, k, v), flush, 3),
            "prefill_swa_attention": time_ms(
                lambda: sw.swa_attention_cuda(*flat, causal=cfg.causal),
                flush, 3),
            "prefill_out_proj": time_ms(
                lambda: L.apply_dense(attn["wo"], o), flush, 3),
            "prefill_mlp": time_ms(lambda: block._ffn(x, cfg), flush, 3),
            "prefill_layer": time_ms(lambda: block(x, cfg), flush, 3)}
        if not cfg.supports_decode:
            return out
        x1 = x[:, :1].contiguous()
        ring = {name: (randn(*r.shape) if r.is_floating_point() else r)
                for name, r in L.init_kv_cache(cfg, b, t, torch.float32,
                                               dev).items()}
        out.update({
            "decode_layer": time_ms(lambda: block.decode(x1, ring, t - 1,
                                                         cfg), flush, 3),
            "decode_unembed": time_ms(lambda: L.unembed(
                model.embedding, x1, cfg), flush, 3)})
    return out


def kv_quant_run(model, prompt, steps):
    """The model once more with ``kv_quant=True`` (the same weights: a
    shallow copy with the flag set) beside its f32 run on one prompt: each
    through the prefill step and its hand-off (f32 rings; int8 rings with
    f16 scales), then ``steps`` decode steps, the f32 run greedy and the
    int8 run fed the f32 run's tokens."""
    from repro_torch.launch.steps import prefill
    from repro_torch.models import decode_step
    b, t = prompt.shape
    quant = copy.copy(model)
    quant.cfg = dataclasses.replace(model.cfg, kv_quant=True)
    runs, feeds = {}, None
    for name, m in (("f32", model), ("int8", quant)):
        with torch.inference_mode():
            zero_counters()
            last, caches = prefill(m, {"tokens": prompt})
            pre = read_counters()
            state = m.cache_from_prefill(caches, b, t + steps, t)
            del caches
            rings = {k: str(r.dtype).split(".")[-1] for k, r in state.items()}
            zero_counters()
            tok = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
            outs, fed = [], []
            for i in range(steps):
                tok = tok if feeds is None else feeds[i]
                lg, state = decode_step(m, tok, state, t + i)
                outs.append(lg[:, 0])
                fed.append(tok)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            del state
            torch.cuda.synchronize()
        runs[name] = {"last": last[:, -1], "logits": torch.stack(outs, 1),
                      "prefill_counts": pre, "decode_counts": read_counters(),
                      "rings": rings}
        feeds = fed if feeds is None else feeds
    f, q = runs["f32"]["logits"], runs["int8"]["logits"]
    top2 = f.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > QUANT_MARGIN
    agree = f.argmax(-1) == q.argmax(-1)
    return {"decode_steps": steps, "rings": runs["int8"]["rings"],
            "agree_by_step_row": agree.t().tolist(),
            "top2_gap_by_step_row": (top2[..., 0] - top2[..., 1]).t()
            .tolist(),
            "max_diff_by_step_row": (q - f).abs().amax(-1).t().tolist(),
            "prefill_counts": runs["int8"]["prefill_counts"],
            "decode_counts": runs["int8"]["decode_counts"],
            "finite_logits": bool(torch.isfinite(q).all()),
            "max_logit_diff_vs_f32": float((q - f).abs().max()),
            "max_abs_f32_logit": float(f.abs().max()),
            "prefill_logits_max_diff_vs_f32": float(
                (runs["int8"]["last"] - runs["f32"]["last"]).abs().max()),
            "margin": QUANT_MARGIN, "positions": int(sure.numel()),
            "positions_past_margin": int(sure.sum()),
            "argmax_agree_past_margin": bool(agree[sure].all()),
            "argmax_agree_all": int(agree.sum())}


def dense_run(dev, arch, b, t, bw, flops, tf32):
    """One dense model at full width, f32, random init from seed 0: a
    256-token warm-up, then the prefill step on a b x t random prompt
    (timed), its hand-off into a ring of t + 32 slots and 32 greedy decode
    steps; continuity of 5 teacher-forced steps after a t - 5 prefill
    against the t-token forward, that prefill keeping the first layer's
    attention inputs for the in-model kernel check; for QUANT_ARCH the
    kv_quant rerun; bounds and stage times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, param_count
    cfg = get_config(arch)
    cache = t + DENSE_STEPS
    free_held(f"dense_serve {arch}")
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_mb = (torch.cuda.memory_allocated() - mem_at_start) / 2**20
    gen = torch.Generator(device=dev).manual_seed(2026)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=dev, dtype=torch.int32)

    warm = _prefill_decode(model, prompt(DENSE_WARM), 2, cache)
    run_prompt = prompt(t)
    run = _prefill_decode(model, run_prompt, DENSE_STEPS, cache)

    swa_cap = _FirstCall(ops.swa_attention)
    cont = continuity(model, {"tokens": prompt(t)}, t - CONT_STEPS, t,
                      (mock.patch.object(ops, "swa_attention", swa_cap),))
    quant = (kv_quant_run(model, run_prompt, QUANT_STEPS)
             if arch == QUANT_ARCH else None)
    peak = torch.cuda.max_memory_allocated()
    in_model = swa_in_model_check(dev, swa_cap.call, None, bw, tf32)
    del swa_cap
    stages = dense_stage_times(model, dev, b, t)
    bounds = dense_bounds(cfg, b, t, DENSE_STEPS, bw, flops, tf32)

    zero = {k: 0 for k in run["prefill_counts"]}
    per_prefill = dict(zero, swa_attention=cfg.num_layers)
    prefills = [warm["prefill_counts"], run["prefill_counts"],
                cont["prefill_counts"]]
    decodes = [warm["decode_counts"], run["decode_counts"]]
    if quant is not None:
        prefills.append(quant["prefill_counts"])
        decodes.append(quant["decode_counts"])
    checks = {
        "swa_per_layer_per_prefill": all(c == per_prefill for c in prefills),
        "no_kernel_in_decode": all(c == zero for c in decodes),
        "continuity_3e-3": cont["within_tol"],
        "swa_attention_in_model_within_3e-5": in_model["within_tol"],
        "swa_attention_in_model_rerun_bit_equal": in_model["rerun_bit_equal"],
        "finite_logits": all(bool(torch.isfinite(r["logits"]).all())
                             for r in (warm, run)),
        "tokens_in_vocab": bool(((run["tokens"] >= 0)
                                 & (run["tokens"] < cfg.vocab_size)).all()),
    }
    if quant is not None:
        checks.update(
            kv_quant_int8_rings=quant["rings"] == {
                "k": "int8", "v": "int8", "k_scale": "float16",
                "v_scale": "float16"},
            kv_quant_finite_logits=quant["finite_logits"],
            kv_quant_argmax_agrees_past_margin=quant[
                "argmax_agree_past_margin"])
    rec = {"phase": "dense_serve", "arch": cfg.name,
           "dtype": cfg.param_dtype, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
           "vocab": cfg.vocab_size, "params": param_count(model),
           "init_s": init_s, "weights_mb": weights_mb, "batch": b,
           "prompt_len": t, "decode_steps": DENSE_STEPS, "ring_slots": cache,
           "warmup_prompt_len": DENSE_WARM,
           "warmup_prefill_ms": warm["prefill_ms"],
           "prefill_ms": run["prefill_ms"],
           "prefill_tok_per_s": b * t * 1e3 / run["prefill_ms"],
           "first_decode_ms": run["first_decode_ms"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_per_s": b * 1e3 / run["decode_ms_per_step"],
           "bound_ms": bounds,
           "prefill_share_of_bound": bounds["prefill"] / run["prefill_ms"],
           "decode_share_of_bound": bounds["decode_step"]
           / run["decode_ms_per_step"],
           "stage_ms": stages,
           **{k: v for k, v in cont.items() if k.startswith("continuity")},
           "in_model_swa_attention": in_model,
           "kv_quant": quant,
           "mem_at_start_mb": mem_at_start / 2**20,
           "peak_mem_mb": peak / 2**20,
           "peak_mem_above_start_mb": (peak - mem_at_start) / 2**20,
           "sampled_ids": run["tokens"][:2, :10].tolist(),
           "launches": {"prefill": run["prefill_counts"],
                        "decode": run["decode_counts"]},
           "checks": checks}
    log(rec)
    del model
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dense_serve {arch}: failed {failed}")
    return rec


def serve_cli_run():
    """The serve CLI's ``main`` with no ``--arch`` (smollm-135m at full
    width, on the card): batch 8, a 512-token prompt, 16 greedy steps into
    a ring that holds them; its printed lines kept."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as cli
    cfg = get_config("smollm-135m")
    buf = io.StringIO()
    torch.cuda.empty_cache()
    zero_counters()
    with contextlib.redirect_stdout(buf):
        out = cli.main(["--batch", str(CLI_BATCH), "--prompt-len",
                        str(CLI_PROMPT), "--steps", str(CLI_STEPS),
                        "--cache", str(CLI_PROMPT + CLI_STEPS)])
    counts = read_counters()
    lines = buf.getvalue().splitlines()
    zero = {k: 0 for k in counts}
    checks = {
        "default_arch_smollm": lines[0].startswith("arch=smollm-135m "),
        "tokens_shape": tuple(out.shape) == (CLI_BATCH, CLI_STEPS + 1),
        "tokens_in_vocab": bool(((out >= 0) & (out < cfg.vocab_size)).all()),
        "swa_per_layer_one_prefill": counts == dict(
            zero, swa_attention=cfg.num_layers)}
    rec = {"phase": "dense_serve_cli", "argv": ["--batch", CLI_BATCH,
                                                "--prompt-len", CLI_PROMPT,
                                                "--steps", CLI_STEPS],
           "stdout": lines, "launches": counts, "checks": checks}
    log(rec)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dense_serve_cli: failed {failed}")
    return rec


def dense_serve(dev, bw, flops, tf32):
    """The four dense models of DENSE_RUNS in turn (each freed before the
    next), then the serve CLI's default run."""
    runs = {arch: dense_run(dev, arch, b, t, bw, flops, tf32)
            for arch, b, t in DENSE_RUNS}
    return {"runs": runs, "cli": serve_cli_run()}


# ---------------------------------------------------------------------------
# phase 15d: the moe family's serving
# ---------------------------------------------------------------------------

# mixtral-8x22b at its published width, its 56 layers cut to MOE_LAYERS (4
# layers are 41.7 GB f32): batch, prompt (past the 4,096-token window, so
# the band cuts and the ring wraps), decode steps, warm-up prompt; the
# continuity prefill (B = 1, past the window, at the dropless capacity
# E / k); the rows of the in-model kernel held against its twin (the
# twin's logits for all 96 rows would take 25.8 GB)
MOE_ARCH, MOE_LAYERS = "mixtral-8x22b", 4
MOE_BATCH, MOE_PROMPT, MOE_STEPS, MOE_WARM = 2, 8192, 32, 256
MOE_CONT_PRE, MOE_CHECK_ROWS = 4160, 8
# the kv_quant rerun's decode steps: 32 steps of 2 rows, 64 positions
MOE_QUANT_STEPS = 32
# llama4-maverick at its published width in bf16, its 48 layers cut to
# one (a layer's 128 experts are 32.2 GB in bf16, 64.4 in f32): batch,
# prompt (the same prompt as mixtral's warm-up and decode steps), the
# continuity prefill (B = 1), its tolerance as a share of the largest
# |logit| (bf16 logits carry bf16 noise of the whole layer and the
# 5,120-wide unembedding: the reduced-precision envelope of the reference's
# bf16 trajectories, 0.02 max|w|, and of the port's int8 continuity), the
# (batch x head) rows of the in-model kernel check
L4_ARCH, L4_LAYERS, L4_DTYPE = "llama4-maverick-400b-a17b", 1, "bfloat16"
L4_BATCH, L4_PROMPT, L4_CONT_PRE, L4_TOL, L4_CHECK_ROWS = (
    2, 4096, 4091, 2e-2, 8)
# the kv_quant rerun's argmax margin, a share of the f32 run's largest
# |logit|: the reference allows int8 decode logits to move 2% of it
# (tests/test_serving.py test_int8_kv_cache_decode_accuracy), so two of
# them can swap an argmax only where their gap is under 4%. QUANT_MARGIN's
# absolute 1e-2 was set at granite's logit scale (its logits scaled by
# 1/16); mixtral's are unscaled, and the int8 rings move them by far more
# than 1e-2 (the record's max_diff_where_routing_matched)
MOE_QUANT_MARGIN_REL = 0.04


class _RouteLog:
    """Wraps ``moe.route``: per call, the kept (token, expert) pairs, the
    chosen pairs and the experts that got a kept token, the keep mask
    itself and the chosen experts (G, g, k) (host reads: in an untimed run
    only)."""

    def __init__(self, fn):
        self.fn, self.calls, self.keeps, self.choices = fn, [], [], []

    def __call__(self, params, xg, cfg, cap):
        out = self.fn(params, xg, cfg, cap)
        keep, pos = out[1], out[2]
        self.calls.append((int(keep.sum()), int((pos >= 0).sum()),
                           int(keep.flatten(0, 1).any(0).sum())))
        self.keeps.append(keep.cpu())
        self.choices.append(out[3].cpu())
        return out


def routing_matched(keeps, layers, steps, batch):
    """The kv_quant rerun's routing, f32 run against int8 run, from a
    ``_RouteLog`` over both (each: a prefill of ``layers`` calls, then
    ``steps`` decode steps of ``layers`` calls on one group of ``batch``
    tokens): (matched (steps, batch) bool, True where the row's keep mask
    was the same in every layer at that step; the (step, layer, row) where
    it was not)."""
    per_run = layers * (1 + steps)
    runs = [keeps[i * per_run + layers:(i + 1) * per_run] for i in (0, 1)]
    matched = torch.ones((steps, batch), dtype=torch.bool)
    flips = []
    for s in range(steps):
        for layer in range(layers):
            a, b = (r[s * layers + layer][0] for r in runs)
            for row in range(batch):
                if not torch.equal(a[row], b[row]):
                    matched[s, row] = False
                    flips.append([s, layer, row])
    return matched, flips


def _band_pairs(t: int, window) -> int:
    """(query, key) pairs of one causal T = S row inside the window."""
    if window is None or t <= window:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def moe_bounds(cfg, b, t, steps, kept_pairs, decode_experts, bw, flops,
               tf32, itemsize=4):
    """The least time of an MoE model's serving, from shapes and this run's
    routing. Prefill: the routed expert work (each token's k experts, three
    d x ff products), the attention projections and the router as f32
    products at the CUDA-core rate (the port's are plain f32 cuBLAS), the
    band's pairs at 4 D operations in three TF32 passes (the kernel's), the
    last position's unembedding. Beside it: the same with the kept pairs
    only (the run's drops, ``kept_pairs`` over all layers); and the extra
    work of the reference's one-hot route, the E x G x C slots beyond the
    routed rows (the port pays those too) and its dispatch and combine
    einsums (the port's index copies do not). A decode step: the bytes it
    must read at the HBM rate, every non-expert weight once (the
    embedding's gather aside), the experts its tokens were routed to
    (``decode_experts``, the mean count of distinct experts a layer), the
    unembedding and the K/V of the attended positions; and the read of all
    experts, which a route that runs every expert pays. bf16 params
    (``itemsize`` 2): the products at the bf16 tensor-core rate (twice
    TF32's), the attention in one bf16 pass, 2 bytes a weight."""
    from repro_torch.models import moe as MOE
    if itemsize == 2:
        flops, att_rate = 2 * tf32, 2 * tf32
    else:
        att_rate = tf32 / 3
    d, hd, v, ff = cfg.d_model, cfg.head_dim, cfg.vocab_size, cfg.d_ff
    h, hkv, n = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    e, k = cfg.num_experts, cfg.experts_per_token
    tok = b * t
    g = min(cfg.moe_group_size, tok)
    ng = -(-tok // g)
    cap = MOE._group_capacity(g, cfg)
    attn_mm = d * hd * (h + 2 * hkv) + h * hd * d
    expert_mm = 3 * d * ff
    routed = 2 * tok * k * expert_mm
    proj = 2 * tok * (attn_mm + d * e)
    attn_flops = 4 * hd * h * b * _band_pairs(t, cfg.sliding_window)
    slot_rows = e * ng * cap
    slot_extra = 2 * (slot_rows - tok * k) * expert_mm
    onehot = 2 * 2 * ng * g * e * cap * d
    ms = {"prefill_routed_experts": n * routed / flops * 1e3,
          "prefill_projections_router": n * proj / flops * 1e3,
          "prefill_attention": n * attn_flops / att_rate * 1e3,
          "prefill_unembed_last": 2 * b * d * v / flops * 1e3}
    ms["prefill"] = sum(ms.values())
    ms["prefill_kept_only"] = ms["prefill"] + (
        2 * kept_pairs * expert_mm - n * routed) / flops * 1e3
    ms["onehot_slots_extra"] = n * slot_extra / flops * 1e3
    ms["onehot_dispatch_combine"] = n * onehot / flops * 1e3
    window = cfg.sliding_window or t + steps
    attended = min(window, t + (steps + 1) / 2)
    common = n * (attn_mm + 2 * d + d * e) + d * v + d
    kv = 2 * n * b * attended * hkv * hd
    ms.update(decode_weights=itemsize * common / bw * 1e3,
              decode_routed_experts=itemsize * n * decode_experts
              * expert_mm / bw * 1e3,
              decode_kv=itemsize * kv / bw * 1e3)
    ms["decode_step"] = (ms["decode_weights"] + ms["decode_routed_experts"]
                         + ms["decode_kv"])
    ms["decode_step_all_experts"] = ms["decode_step"] + itemsize * n * (
        e - decode_experts) * expert_mm / bw * 1e3
    ms.update(prefill_routed_flops_per_layer=routed,
              prefill_projection_router_flops_per_layer=proj,
              prefill_attention_flops_per_layer=attn_flops,
              group=g, groups=ng, capacity=cap, slot_rows=slot_rows,
              routed_rows=tok * k,
              onehot_slot_extra_flops_per_layer=slot_extra,
              onehot_dispatch_combine_flops_per_layer=onehot,
              decode_experts_per_layer=decode_experts,
              decode_bytes_per_step=itemsize * (common + n * decode_experts
                                                * expert_mm + kv),
              decode_bytes_per_step_all_experts=itemsize * (
                  common + n * e * expert_mm + kv))
    return ms


def moe_stage_times(model, dev, b, t, ring):
    """ms of one MoE layer's stages at the run's shapes (CUDA events, L2
    flushed, the median of 3 calls after 5): prefill over b x t tokens, the
    Q, K, V projections, RoPE on q and k, the GQA repeat with the (B H, T,
    D) copies ops.swa_attention makes, the swa_attention kernel (window
    4,096), the output projection, the router with top-k and the dispatch
    copies, the experts' products, the combine, the MoE half (norm, MoE,
    residual), the whole layer; decode, one layer over a full ring, its MoE
    half and the unembedding of one token a row."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cfg = model.cfg
    block = model.layers[0]
    attn, moe = block.attn, block.moe
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    flush = l2_flush(dev)
    gen = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {}
    with torch.inference_mode():
        x, o = randn(b, t, cfg.d_model), randn(b, t, h * hd)
        out["prefill_qkv_proj"] = time_ms(lambda: [
            L.apply_dense(attn[w], x) for w in ("wq", "wk", "wv")], flush, 3)
        out["prefill_out_proj"] = time_ms(
            lambda: L.apply_dense(attn["wo"], o), flush, 3)
        del o
        q, k, v = randn(b, t, h, hd), randn(b, t, hkv, hd), randn(b, t, hkv,
                                                                 hd)
        pos = torch.arange(t, device=dev)
        out["prefill_rope"] = time_ms(lambda: (
            L.rope_rotate(q, pos, cfg.rope_theta),
            L.rope_rotate(k, pos, cfg.rope_theta)), flush, 3)
        out["prefill_gqa_repeat_layout"] = time_ms(
            lambda: ops.swa_layout(q, k, v), flush, 3)
        flat = ops.swa_layout(q, k, v)
        out["prefill_swa_attention"] = time_ms(
            lambda: sw.swa_attention_cuda(*flat, window=cfg.sliding_window),
            flush, 3)
        del q, k, v, flat
        out["prefill_router_dispatch"] = time_ms(
            lambda: MOE.dispatch(moe, x, cfg), flush, 3)
        exp_in, rows, w, _ = MOE.dispatch(moe, x, cfg)
        out["prefill_experts"] = time_ms(
            lambda: MOE.expert_ffn(moe, exp_in), flush, 3)
        exp_out = MOE.expert_ffn(moe, exp_in)
        del exp_in
        out["prefill_combine"] = time_ms(
            lambda: MOE.combine(exp_out, rows, w), flush, 3)
        del exp_out, rows, w
        out["prefill_moe"] = time_ms(lambda: block._ffn(x, cfg), flush, 3)
        out["prefill_layer"] = time_ms(lambda: block(x, cfg), flush, 3)
        x1 = x[:, :1].contiguous()
        del x
        cache = {name: (randn(*r.shape) if r.is_floating_point() else r)
                 for name, r in L.init_kv_cache(cfg, b, ring, torch.float32,
                                                dev).items()}
        out["decode_layer"] = time_ms(
            lambda: block.decode(x1, cache, t, cfg), flush, 3)
        out["decode_moe"] = time_ms(lambda: block._ffn(x1, cfg), flush, 3)
        out["decode_unembed"] = time_ms(
            lambda: L.unembed(model.embedding, x1, cfg), flush, 3)
    return out


def moe_serve(dev, bw, flops, tf32):
    """mixtral-8x22b at its published width (d_model 6144, 48 query heads
    over 8 kv heads, D = 128, W = 4096, 8 experts top-2 of d_ff 16384,
    capacity factor 1.25, vocab 32,768, untied), its depth cut to
    MOE_LAYERS, f32, random init from seed 0: a 256-token warm-up, then
    batch 2 through the prefill step on an 8,192-token prompt twice (the
    first call builds the band plan at the new T and keeps the first
    layer's attention inputs and every layer's routing; the second is the
    timed run) with 32 greedy decode steps after it over the 4,096-slot
    ring; continuity of 5 teacher-forced steps after a B = 1 prefill of
    4,160 tokens (past the window: the ring wraps) against the 4,165-token
    forward, at the dropless capacity E / k = 4; the kv_quant rerun over
    32 decode steps (64 positions); the kernel against its twin on the
    model's own inputs; bounds and stage times. Then llama4-maverick's
    bf16 row (``llama4_row``), returned under ``"llama4"``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, param_count
    from repro_torch.models import moe as MOE
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    b, t = MOE_BATCH, MOE_PROMPT
    cache = t + MOE_STEPS
    ring = min(cache, cfg.sliding_window)
    free_held("moe_serve")
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_mb = (torch.cuda.memory_allocated() - mem_at_start) / 2**20
    gen = torch.Generator(device=dev).manual_seed(2027)

    def prompt(bb, n):
        return torch.randint(0, cfg.vocab_size, (bb, n), generator=gen,
                             device=dev, dtype=torch.int32)

    warm = _prefill_decode(model, prompt(b, MOE_WARM), 2, cache)
    swa_cap = _FirstCall(ops.swa_attention)
    routes = _RouteLog(MOE.route)
    with mock.patch.object(ops, "swa_attention", swa_cap), \
            mock.patch.object(MOE, "route", routes):
        first = _prefill_decode(model, prompt(b, t), 2, cache)
    peak_first = torch.cuda.max_memory_allocated()
    in_model = swa_in_model_check(dev, swa_cap.call, cfg.sliding_window,
                                  bw, tf32, check_rows=MOE_CHECK_ROWS)
    del swa_cap
    torch.cuda.reset_peak_memory_stats()
    run_prompt = prompt(b, t)
    run = _prefill_decode(model, run_prompt, MOE_STEPS, cache)

    dropless = copy.copy(model)
    dropless.cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    cont = continuity(dropless, {"tokens": prompt(1, MOE_CONT_PRE
                                                  + CONT_STEPS)},
                      MOE_CONT_PRE, MOE_CONT_PRE + CONT_STEPS)
    del dropless
    quant_routes = _RouteLog(MOE.route)
    with mock.patch.object(MOE, "route", quant_routes):
        quant = kv_quant_run(model, run_prompt, MOE_QUANT_STEPS)
    # a (token, expert) choice that the int8 rings' rounding flips changes
    # that token's FFN outright: the runs are then different computations,
    # so argmax agreement is held where every layer routed the row alike
    matched, flips = routing_matched(quant_routes.keeps, cfg.num_layers,
                                     MOE_QUANT_STEPS, b)
    del quant_routes
    agree = torch.tensor(quant["agree_by_step_row"])
    margin = MOE_QUANT_MARGIN_REL * quant["max_abs_f32_logit"]
    held = (torch.tensor(quant["top2_gap_by_step_row"]) > margin) & matched
    diff = torch.tensor(quant["max_diff_by_step_row"])
    quant.update(routing_flips=flips,
                 positions_routing_matched=int(matched.sum()),
                 margin_rel=MOE_QUANT_MARGIN_REL, margin_abs=margin,
                 positions_checked=int(held.sum()),
                 max_diff_where_routing_matched=float(diff[matched].max()),
                 argmax_agree_where_routing_matched=bool(agree[held].all()))
    peak = max(peak_first, torch.cuda.max_memory_allocated())
    stages = moe_stage_times(model, dev, b, t, ring)

    pre_routes = routes.calls[:cfg.num_layers]
    dec_routes = routes.calls[cfg.num_layers:]
    kept = sum(c[0] for c in pre_routes)
    chosen = sum(c[1] for c in pre_routes)
    dec_experts = sum(c[2] for c in dec_routes) / len(dec_routes)
    bounds = moe_bounds(cfg, b, t, MOE_STEPS, kept, dec_experts, bw, flops,
                        tf32)

    zero = {k: 0 for k in run["prefill_counts"]}
    per_prefill = dict(zero, swa_attention=cfg.num_layers)
    prefills = [warm["prefill_counts"], first["prefill_counts"],
                run["prefill_counts"], cont["prefill_counts"],
                quant["prefill_counts"]]
    decodes = [warm["decode_counts"], first["decode_counts"],
               run["decode_counts"], quant["decode_counts"]]
    checks = {
        "swa_per_layer_per_prefill": all(c == per_prefill for c in prefills),
        "no_kernel_in_decode": all(c == zero for c in decodes),
        "continuity_3e-3": cont["within_tol"],
        "swa_attention_in_model_within_3e-5": in_model["within_tol"],
        "swa_attention_in_model_rerun_bit_equal": in_model[
            "rerun_bit_equal"],
        "finite_logits": all(bool(torch.isfinite(r["logits"]).all())
                             for r in (warm, first, run)),
        "tokens_in_vocab": bool(((run["tokens"] >= 0)
                                 & (run["tokens"] < cfg.vocab_size)).all()),
        "routing_logged_per_layer": len(pre_routes) == cfg.num_layers
        and len(dec_routes) == 2 * cfg.num_layers,
        "kv_quant_int8_rings": quant["rings"] == {
            "k": "int8", "v": "int8", "k_scale": "float16",
            "v_scale": "float16"},
        "kv_quant_finite_logits": quant["finite_logits"],
        "kv_quant_argmax_agrees_past_margin_where_routing_matched": quant[
            "argmax_agree_where_routing_matched"]
        and quant["positions_checked"] > 0,
    }
    tokens = b * t
    rec = {"phase": "moe_serve", "arch": cfg.name, "dtype": cfg.param_dtype,
           "reduced": {"num_layers": [full.num_layers, cfg.num_layers]},
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "window": cfg.sliding_window,
           "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
           "d_ff": cfg.d_ff, "capacity_factor": cfg.capacity_factor,
           "vocab": cfg.vocab_size, "params": param_count(model),
           "init_s": init_s, "weights_mb": weights_mb, "batch": b,
           "prompt_len": t, "decode_steps": MOE_STEPS, "ring_slots": ring,
           "warmup_prompt_len": MOE_WARM,
           "warmup_prefill_ms": warm["prefill_ms"],
           "prefill_ms_first_call_at_t": first["prefill_ms"],
           "prefill_ms": run["prefill_ms"],
           "prefill_tok_per_s": tokens * 1e3 / run["prefill_ms"],
           "first_decode_ms": run["first_decode_ms"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_per_s": b * 1e3 / run["decode_ms_per_step"],
           "prefill_routing": {"kept_pairs": kept, "chosen_pairs": chosen,
                               "dropped_share": 1 - kept / chosen,
                               "per_layer": pre_routes},
           "decode_routing_first_steps": dec_routes,
           "bound_ms": bounds,
           "prefill_share_of_bound": bounds["prefill"] / run["prefill_ms"],
           "decode_share_of_bound": bounds["decode_step"]
           / run["decode_ms_per_step"],
           "stage_ms": stages,
           "continuity_capacity_factor": cfg.num_experts
           / cfg.experts_per_token,
           **{k: v for k, v in cont.items() if k.startswith("continuity")},
           "in_model_swa_attention": in_model,
           "kv_quant": quant,
           "mem_at_start_mb": mem_at_start / 2**20,
           "peak_mem_mb": peak / 2**20,
           "peak_mem_above_start_mb": (peak - mem_at_start) / 2**20,
           "sampled_ids": run["tokens"][:, :10].tolist(),
           "launches": {"prefill": run["prefill_counts"],
                        "decode": run["decode_counts"]},
           "checks": checks}
    log(rec)
    del model
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"moe_serve: failed {failed}")
    rec["llama4"] = llama4_row(dev, bw, flops, tf32)
    return rec


def llama4_row(dev, bw, flops, tf32):
    """llama4-maverick-400b-a17b at its published width (d_model 5120, 40
    query heads over 8, D = 128, no window, 128 experts top-1 of d_ff
    8192, capacity factor 1.25, vocab 202,048, untied), its depth cut to
    L4_LAYERS, bf16 params, random init from seed 0 (each expert tensor
    drawn in f32, then cast: the init's peak is logged apart): a 256-token
    warm-up, then batch 2 through the prefill step on a 4,096-token prompt
    twice (the first keeps the first layer's attention inputs and the
    routing; the second is timed) with 32 greedy decode steps after it;
    continuity of 5 teacher-forced steps after a B = 1 prefill of 4,091
    tokens at the dropless capacity E / k = 128, within 2e-2 of the
    largest |logit| where the decode step chose the full forward's expert
    (a flip changes the token's FFN outright: flips are logged, as the
    mixtral kv_quant rerun's are; the elementwise rtol / atol 2e-2 verdict
    is logged beside it); the kernel against its twin on 8 of the first
    layer's (batch x head) rows at the bf16 3e-2; bounds."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, param_count
    from repro_torch.models import moe as MOE
    full = get_config(L4_ARCH)
    cfg = dataclasses.replace(full, num_layers=L4_LAYERS,
                              param_dtype=L4_DTYPE)
    b, t, n = L4_BATCH, L4_PROMPT, L4_LAYERS
    cache = t + MOE_STEPS
    free_held("moe_serve llama4")
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weights_mb = (torch.cuda.memory_allocated() - mem_at_start) / 2**20
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(2028)

    def prompt(bb, m):
        return torch.randint(0, cfg.vocab_size, (bb, m), generator=gen,
                             device=dev, dtype=torch.int32)

    warm = _prefill_decode(model, prompt(b, MOE_WARM), 2, cache)
    swa_cap = _FirstCall(ops.swa_attention)
    routes = _RouteLog(MOE.route)
    with mock.patch.object(ops, "swa_attention", swa_cap), \
            mock.patch.object(MOE, "route", routes):
        first = _prefill_decode(model, prompt(b, t), 2, cache)
    in_model = swa_in_model_check(dev, swa_cap.call, None, bw, tf32,
                                  check_rows=L4_CHECK_ROWS)
    del swa_cap
    run = _prefill_decode(model, prompt(b, t), MOE_STEPS, cache)

    dropless = copy.copy(model)
    dropless.cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    cont_routes = _RouteLog(MOE.route)
    t_cont = L4_CONT_PRE + CONT_STEPS
    with mock.patch.object(MOE, "route", cont_routes):
        cont = continuity(dropless, {"tokens": prompt(1, t_cont)},
                          L4_CONT_PRE, t_cont, tol=L4_TOL)
    del dropless
    # the route calls: the full forward's n, the prefill's n, then n per
    # decode step; a decode token's expert against the full forward's at
    # its position (groups of g tokens, in token order)
    fwd = [c.reshape(-1, c.shape[-1])[:t_cont] for c in
           cont_routes.choices[:n]]
    matched, flips = [], []
    for i in range(CONT_STEPS):
        same = True
        for layer in range(n):
            dec = cont_routes.choices[2 * n + i * n + layer].reshape(-1)
            if not torch.equal(dec, fwd[layer][L4_CONT_PRE + i]):
                same = False
                flips.append([i, layer, int(fwd[layer][L4_CONT_PRE + i][0]),
                              int(dec[0])])
        matched.append(same)
    del cont_routes
    within = cont["within_tol_by_row_step"][0]
    limit = L4_TOL * cont["continuity_max_abs_logit"]
    held = [d <= limit for d, m in zip(cont["max_abs_diff_by_row_step"][0],
                                       matched) if m]
    peak = torch.cuda.max_memory_allocated()

    pre_routes = routes.calls[:n]
    dec_routes = routes.calls[n:]
    kept = sum(c[0] for c in pre_routes)
    chosen = sum(c[1] for c in pre_routes)
    dec_experts = sum(c[2] for c in dec_routes) / len(dec_routes)
    bounds = moe_bounds(cfg, b, t, MOE_STEPS, kept, dec_experts, bw, flops,
                        tf32, itemsize=2)

    zero = {k: 0 for k in run["prefill_counts"]}
    per_prefill = dict(zero, swa_attention=n)
    prefills = [warm["prefill_counts"], first["prefill_counts"],
                run["prefill_counts"], cont["prefill_counts"]]
    decodes = [warm["decode_counts"], first["decode_counts"],
               run["decode_counts"]]
    checks = {
        "swa_per_layer_per_prefill": all(c == per_prefill for c in prefills),
        "no_kernel_in_decode": all(c == zero for c in decodes),
        "continuity_2e-2_of_max_logit_where_routing_matched": bool(held)
        and all(held),
        "continuity_prefill_logits_2e-2_of_max_logit": cont[
            "continuity_prefill_logits_max_abs_diff"] <= limit,
        "swa_attention_in_model_within_3e-2": in_model["within_tol"],
        "swa_attention_in_model_rerun_bit_equal": in_model[
            "rerun_bit_equal"],
        "finite_logits": all(bool(torch.isfinite(r["logits"]).all())
                             for r in (warm, first, run)),
        "tokens_in_vocab": bool(((run["tokens"] >= 0)
                                 & (run["tokens"] < cfg.vocab_size)).all()),
        "routing_logged_per_layer": len(pre_routes) == n
        and len(dec_routes) == 2 * n,
    }
    rec = {"phase": "moe_serve", "arch": cfg.name, "dtype": cfg.param_dtype,
           "reduced": {"num_layers": [full.num_layers, n],
                       "param_dtype": [full.param_dtype, cfg.param_dtype]},
           "layers": n, "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
           "window": cfg.sliding_window, "experts": cfg.num_experts,
           "top_k": cfg.experts_per_token, "d_ff": cfg.d_ff,
           "capacity_factor": cfg.capacity_factor, "vocab": cfg.vocab_size,
           "params": param_count(model), "init_s": init_s,
           "weights_mb": weights_mb, "batch": b, "prompt_len": t,
           "decode_steps": MOE_STEPS, "ring_slots": cache,
           "warmup_prompt_len": MOE_WARM,
           "warmup_prefill_ms": warm["prefill_ms"],
           "prefill_ms_first_call_at_t": first["prefill_ms"],
           "prefill_ms": run["prefill_ms"],
           "prefill_tok_per_s": b * t * 1e3 / run["prefill_ms"],
           "first_decode_ms": run["first_decode_ms"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_per_s": b * 1e3 / run["decode_ms_per_step"],
           "prefill_routing": {"kept_pairs": kept, "chosen_pairs": chosen,
                               "dropped_share": 1 - kept / chosen,
                               "per_layer": pre_routes},
           "decode_routing_first_steps": dec_routes,
           "bound_ms": bounds,
           "prefill_share_of_bound": bounds["prefill"] / run["prefill_ms"],
           "decode_share_of_bound": bounds["decode_step"]
           / run["decode_ms_per_step"],
           "continuity_capacity_factor": cfg.num_experts
           / cfg.experts_per_token,
           **{k: v for k, v in cont.items() if k.startswith("continuity")},
           "continuity_limit_abs": limit,
           "continuity_max_abs_diff_by_step": cont[
               "max_abs_diff_by_row_step"][0],
           "continuity_within_rtol_atol_2e-2_by_step": within,
           "continuity_routing_matched_by_step": matched,
           "continuity_routing_flips": flips,
           "in_model_swa_attention": in_model,
           "mem_at_start_mb": mem_at_start / 2**20,
           "init_peak_mem_mb": init_peak / 2**20,
           "peak_mem_mb": peak / 2**20,
           "peak_mem_above_start_mb": (max(peak, init_peak) - mem_at_start)
           / 2**20,
           "sampled_ids": run["tokens"][:, :10].tolist(),
           "launches": {"prefill": run["prefill_counts"],
                        "decode": run["decode_counts"]},
           "checks": checks}
    log(rec)
    del model
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"moe_serve {cfg.name}: failed {failed}")
    return rec


# ---------------------------------------------------------------------------
# phases 15e-15f: the vlm family's serving, the audio family's encoder
# ---------------------------------------------------------------------------

# internvl2-1b at full width: batch, text tokens after the 256 patches
# (4,096 positions), decode steps, warm-up text, the continuity's text
# prefill (decode then runs VLM_STEPS teacher-forced steps over its rest)
VLM_ARCH, VLM_BATCH, VLM_TEXT, VLM_STEPS, VLM_WARM, VLM_CONT_TEXT = (
    "internvl2-1b", 2, 3840, 32, 256, 1000)
# hubert-xlarge at full width: clips, frames (30 s at HuBERT's 20 ms hop),
# the first frame changed in the bidirectionality check, the early frames
# it reads, the timed long row's T
AUDIO_ARCH, AUDIO_BATCH, AUDIO_FRAMES, AUDIO_RAISE_FROM, AUDIO_EARLY = (
    "hubert-xlarge", 8, 1500, 1400, 10)
AUDIO_LONG_T = 8192


def vlm_serve(dev, bw, flops, tf32):
    """internvl2-1b at full width (24 layers, d_model 896, 14 query heads
    over 2, D = 64, d_ff 4864, 256 patches of 1024-d through the
    projector, tied vocab 151,655), f32, random init from seed 0: a
    warm-up, then batch 2 through the prefill step on [256 random patch
    embeddings; 3,840 random tokens] twice (the first keeps the first
    layer's attention inputs: the kernel against its twin there on every
    row, GQA 7 included; the second is timed) with 32 greedy decode steps
    from index 4,096; continuity of 32 teacher-forced steps after a
    prefill of [patches; 1,000 tokens]; the prefill caches cover patches
    and text; the patches move the text's logits; bounds (``dense_bounds``
    and the projector) and stage times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import prefill
    from repro_torch.models import init_model, param_count
    from repro_torch.models import layers as L
    cfg = get_config(VLM_ARCH)
    b, p, tt = VLM_BATCH, cfg.num_patches, VLM_TEXT
    n = p + tt
    cache = n + VLM_STEPS
    free_held("vlm_serve")
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_mb = (torch.cuda.memory_allocated() - mem_at_start) / 2**20
    gen = torch.Generator(device=dev).manual_seed(2029)

    def prompt(m):
        return torch.randint(0, cfg.vocab_size, (b, m), generator=gen,
                             device=dev, dtype=torch.int32)

    def patches():
        return torch.randn((b, p, cfg.frontend_dim), generator=gen,
                           device=dev)

    warm_batch = {"tokens": prompt(VLM_WARM), "patch_embeds": patches()}
    warm = _prefill_decode(model, warm_batch["tokens"], 2, cache,
                           warm_batch["patch_embeds"])
    swa_cap = _FirstCall(ops.swa_attention)
    with mock.patch.object(ops, "swa_attention", swa_cap):
        first = _prefill_decode(model, prompt(tt), 2, cache, patches())
    in_model = swa_in_model_check(dev, swa_cap.call, None, bw, tf32)
    del swa_cap
    run = _prefill_decode(model, prompt(tt), VLM_STEPS, cache, patches())

    cont_text = VLM_CONT_TEXT + VLM_STEPS
    cont = continuity(model, {"tokens": prompt(cont_text),
                              "patch_embeds": patches()},
                      VLM_CONT_TEXT, p + cont_text)
    with torch.inference_mode():
        last, caches = prefill(model, warm_batch)
        cache_len = caches["k"].shape[2]
        del caches
        moved, _ = prefill(model, dict(warm_batch,
                                       patch_embeds=patches()))
    patch_effect = float((moved - last).abs().max())
    peak = torch.cuda.max_memory_allocated()

    stages = dense_stage_times(model, dev, b, n)
    flush = l2_flush(dev)
    pe = patches()
    with torch.inference_mode():
        stages["prefill_projector"] = time_ms(
            lambda: L.apply_dense(model.projector, pe), flush, 3)
    del pe
    bounds = dense_bounds(cfg, b, n, VLM_STEPS, bw, flops, tf32)
    proj_flops = 2 * b * p * cfg.frontend_dim * cfg.d_model
    bounds.update(prefill_projector=proj_flops / flops * 1e3,
                  prefill_projector_flops=proj_flops)
    bounds["prefill"] += bounds["prefill_projector"]

    zero = {k: 0 for k in run["prefill_counts"]}
    per_prefill = dict(zero, swa_attention=cfg.num_layers)
    prefills = [warm["prefill_counts"], first["prefill_counts"],
                run["prefill_counts"], cont["prefill_counts"]]
    decodes = [warm["decode_counts"], first["decode_counts"],
               run["decode_counts"]]
    checks = {
        "swa_per_layer_per_prefill": all(c == per_prefill for c in prefills),
        "no_kernel_in_decode": all(c == zero for c in decodes),
        "caches_cover_patches_and_text": cache_len == p + VLM_WARM,
        "patches_move_text_logits": patch_effect > 1e-4,
        "continuity_3e-3": cont["within_tol"],
        "swa_attention_in_model_within_3e-5": in_model["within_tol"],
        "swa_attention_in_model_rerun_bit_equal": in_model["rerun_bit_equal"],
        "finite_logits": all(bool(torch.isfinite(r["logits"]).all())
                             for r in (warm, first, run)),
        "tokens_in_vocab": bool(((run["tokens"] >= 0)
                                 & (run["tokens"] < cfg.vocab_size)).all()),
    }
    rec = {"phase": "vlm_serve", "arch": cfg.name, "dtype": cfg.param_dtype,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
           "patches": p, "frontend_dim": cfg.frontend_dim,
           "params": param_count(model), "init_s": init_s,
           "weights_mb": weights_mb, "batch": b, "text_len": tt,
           "prefill_positions": n, "decode_steps": VLM_STEPS,
           "decode_start_index": n, "ring_slots": cache,
           "warmup_text_len": VLM_WARM,
           "warmup_prefill_ms": warm["prefill_ms"],
           "prefill_ms_first_call_at_t": first["prefill_ms"],
           "prefill_ms": run["prefill_ms"],
           "prefill_positions_per_s": b * n * 1e3 / run["prefill_ms"],
           "first_decode_ms": run["first_decode_ms"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_per_s": b * 1e3 / run["decode_ms_per_step"],
           "bound_ms": bounds,
           "prefill_share_of_bound": bounds["prefill"] / run["prefill_ms"],
           "decode_share_of_bound": bounds["decode_step"]
           / run["decode_ms_per_step"],
           "stage_ms": stages,
           **{k: v for k, v in cont.items() if k.startswith("continuity")},
           "patch_change_max_logit_move": patch_effect,
           "in_model_swa_attention": in_model,
           "mem_at_start_mb": mem_at_start / 2**20,
           "peak_mem_mb": peak / 2**20,
           "peak_mem_above_start_mb": (peak - mem_at_start) / 2**20,
           "sampled_ids": run["tokens"][:, :10].tolist(),
           "launches": {"prefill": run["prefill_counts"],
                        "decode": run["decode_counts"]},
           "checks": checks}
    log(rec)
    del model
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"vlm_serve: failed {failed}")
    return rec


def audio_bounds(cfg, b, t, bw, flops, tf32):
    """The least time of hubert's encoder pass, from shapes: the frontend
    projection, each layer's projections and MLP and the unembedding of
    every frame as f32 products at the CUDA-core rate (plain f32 cuBLAS),
    the attention's T x T pairs at 4 D operations in three TF32 passes
    (the kernel's), and beside it at the kernel's padded head dim."""
    from repro_torch.kernels import swa_attention as sw
    d, hd, v, f = cfg.d_model, cfg.head_dim, cfg.vocab_size, cfg.frontend_dim
    h, hkv, n = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    mm = d * hd * (h + 2 * hkv) + h * hd * d + 3 * d * cfg.d_ff
    proj_flops = 2 * b * t * n * mm
    attn_flops = 4 * hd * n * h * b * t * t
    dp = sw.tiles(hd)[0]
    ms = {"encoder_frontend_proj": 2 * b * t * f * d / flops * 1e3,
          "encoder_projections": proj_flops / flops * 1e3,
          "encoder_attention": 3 * attn_flops / tf32 * 1e3,
          "encoder_unembed": 2 * b * t * d * v / flops * 1e3}
    ms["encoder"] = sum(ms.values())
    ms.update(encoder_attention_at_padded_d=3 * attn_flops * dp / hd / tf32
              * 1e3, padded_head_dim=dp, attention_pad_share=1 - hd / dp,
              encoder_projection_flops=proj_flops,
              encoder_attention_flops=attn_flops)
    return ms


def audio_long_row(dev, cfg, bw, flops, tf32):
    """The attention kernel at hubert's heads (16 of D = 80, bidirectional,
    no window) on one 8,192-frame clip of std-1 inputs: against its twin
    at 3e-5, then timed beside the twin and SDPA (``is_causal=False``, no
    mask, the efficient backend forced) on the same (1, 16, T, 80)
    inputs; bounds at D = 80 and at the kernel's padded D."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    h, d, t = cfg.num_heads, cfg.head_dim, AUDIO_LONG_T
    flush = l2_flush(dev)
    qf, kf, vf = ops.swa_layout(*swa_inputs(dev, 1, t, h, cfg.num_kv_heads,
                                            d, torch.float32, 9))
    got = sw.swa_attention_cuda(qf, kf, vf, causal=False)
    want = sw.swa_attention_plain(qf, kf, vf, causal=False)
    err = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, rtol=3e-5, atol=3e-5))
    del want
    q4, k4, v4 = (x.view(1, h, t, d) for x in (qf, kf, vf))

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=False)

    lib_err = float((library().view(h, t, d) - got).abs().max())
    del got
    pairs, nops, nbytes = swa_work(h, t, d, None, 4, dev, causal=False)
    dp = sw.tiles(d)[0]
    rec = {"model": AUDIO_ARCH, "shape": [h, t, d], "kv_heads": h,
           "window": None, "causal": False, "dtype": "float32",
           "max_abs_err": err, "within_3e-5": close,
           "ms": time_ms(lambda: sw.swa_attention_cuda(qf, kf, vf,
                                                       causal=False), flush),
           "plain_ms": time_ms(lambda: sw.swa_attention_plain(
               qf, kf, vf, causal=False), flush, 10),
           "library_ms": time_ms(library, flush),
           "library": "F.scaled_dot_product_attention(q, k, v, "
                      "is_causal=False) on (1, H, T, D), "
                      "EFFICIENT_ATTENTION",
           "library_max_abs_diff_vs_kernel": lib_err,
           "pairs_counted": pairs, "flops_counted": nops,
           "bytes_counted": nbytes,
           "bound_at_padded_d_ms": 3 * nops * dp / d / tf32 * 1e3,
           "bound_cuda_cores_ms": max(nbytes / bw, nops / flops) * 1e3,
           **_bound(nbytes, 3 * nops, bw, tf32)}
    log({"phase": "kernel_time", "kernel": "swa_attention", **rec})
    return rec


def audio_encode(dev, bw, flops, tf32):
    """hubert-xlarge at full width (48 layers, d_model 1280, 16 heads of
    D = 80, bidirectional, d_ff 5120, 512-d frame features through the
    frontend projection, an untied 504-entry unembedding), f32, random
    init from seed 0: 8 clips of 1,500 frames with ``mask_indicator`` drawn
    at mask_prob 0.08; a warm-up pass, a pass that keeps the first layer's
    attention inputs (the kernel against its twin there, every row, and
    against f64), two timed passes of ``forward`` (all 1,500 frames'
    logits); the prefill step's last frame; the masked frames are
    ``mask_emb`` exactly; changing frames 1,400 on moves frames 0-9's
    logits; the decode entry points refuse by name; the kernel's long row
    (``audio_long_row``); bounds and stage times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import prefill
    from repro_torch.models import forward, init_model, param_count
    from repro_torch.models import layers as L
    cfg = get_config(AUDIO_ARCH)
    b, t = AUDIO_BATCH, AUDIO_FRAMES
    free_held("audio_encode")
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_mb = (torch.cuda.memory_allocated() - mem_at_start) / 2**20
    gen = torch.Generator(device=dev).manual_seed(2030)
    feats = torch.randn((b, t, cfg.frontend_dim), generator=gen, device=dev)
    mask = (torch.rand((b, t), generator=gen, device=dev)
            < cfg.mask_prob).to(torch.int32)
    batch = {"frame_feats": feats, "mask_indicator": mask}

    def encode(bt):
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _, caches = forward(model, bt)
        torch.cuda.synchronize()
        return logits, caches, (time.perf_counter() - t0) * 1e3, \
            read_counters()

    _, _, warm_ms, warm_counts = encode(batch)
    swa_cap = _FirstCall(ops.swa_attention)
    with mock.patch.object(ops, "swa_attention", swa_cap):
        logits, caches, _, first_counts = encode(batch)
    in_model = swa_in_model_check(dev, swa_cap.call, None, bw, tf32,
                                  causal=False)
    del swa_cap
    timed = [encode(batch) for _ in range(2)]
    same = all(bool(torch.equal(r[0], logits)) for r in timed)
    timed_diff = max(float((r[0] - logits).abs().max()) for r in timed)
    enc_ms = [r[2] for r in timed]
    counts = [warm_counts, first_counts] + [r[3] for r in timed]
    del timed

    zero_counters()
    last, pre_caches = prefill(model, batch)
    prefill_counts = read_counters()
    last_diff = float((last[:, 0] - logits[:, -1]).abs().max())
    with torch.inference_mode():
        x = model.embed_inputs(batch)
        m = mask.bool()
        masked_exact = bool(torch.equal(
            x[m], model.mask_emb.expand(int(m.sum()), -1)))
        del x
    raised = dict(batch, frame_feats=feats.clone())
    raised["frame_feats"][:, AUDIO_RAISE_FROM:] += 3.0
    moved, _, _, _ = encode(raised)
    early_move = float((moved[:, :AUDIO_EARLY]
                        - logits[:, :AUDIO_EARLY]).abs().max())
    del moved, raised
    try:
        model.init_decode_state(b, 64)
        refusal = None
    except NotImplementedError as exc:
        refusal = str(exc)
    peak = torch.cuda.max_memory_allocated()

    long_row = audio_long_row(dev, cfg, bw, flops, tf32)
    stages = dense_stage_times(model, dev, b, t)
    flush = l2_flush(dev)
    with torch.inference_mode():
        h = torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
        stages["encoder_frontend_proj"] = time_ms(
            lambda: L.apply_dense(model.frontend_proj, feats), flush, 3)
        stages["encoder_unembed"] = time_ms(
            lambda: L.unembed(model.embedding, h, cfg), flush, 3)
        del h
    bounds = audio_bounds(cfg, b, t, bw, flops, tf32)

    zero = {k: 0 for k in counts[0]}
    per_pass = dict(zero, swa_attention=cfg.num_layers)
    checks = {
        "swa_per_layer_per_pass": all(c == per_pass for c in counts
                                      + [prefill_counts]),
        "logits_shape": tuple(logits.shape) == (b, t, cfg.vocab_size),
        "finite_logits": bool(torch.isfinite(logits).all()),
        "no_caches": caches is None and pre_caches is None,
        "masked_frames_are_mask_emb": masked_exact and bool(m.any()),
        "bidirectional_early_logits_move_over_1e-4": early_move > 1e-4,
        "prefill_last_frame_1e-4": last_diff <= 1e-4,
        "decode_refused_by_name": refusal is not None
        and "encoder_only" in refusal,
        "swa_attention_in_model_within_3e-5": in_model["within_tol"],
        "swa_attention_in_model_rerun_bit_equal": in_model["rerun_bit_equal"],
        "swa_attention_long_row_within_3e-5": long_row["within_3e-5"],
    }
    rec = {"phase": "audio_encode", "arch": cfg.name,
           "dtype": cfg.param_dtype, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
           "causal": cfg.causal, "vocab": cfg.vocab_size,
           "params": param_count(model), "init_s": init_s,
           "weights_mb": weights_mb, "batch": b, "frames": t,
           "frontend_dim": cfg.frontend_dim, "mask_prob": cfg.mask_prob,
           "masked_frames": int(mask.sum()), "warmup_encoder_ms": warm_ms,
           "encoder_ms": enc_ms, "repeat_passes_bit_equal": same,
           "repeat_passes_max_diff": timed_diff,
           "encoder_frames_per_s": b * t * 1e3 / min(enc_ms),
           "audio_s_per_s": b * t * 0.02 * 1e3 / min(enc_ms),
           "bound_ms": bounds,
           "encoder_share_of_bound": bounds["encoder"] / min(enc_ms),
           "stage_ms": stages,
           "raised_frames_from": AUDIO_RAISE_FROM,
           "bidirectional_first_10_frames_max_move": early_move,
           "prefill_step_last_frame_max_diff": last_diff,
           "decode_refusal": refusal,
           "in_model_swa_attention": in_model,
           "long_row_swa_attention": long_row,
           "mem_at_start_mb": mem_at_start / 2**20,
           "peak_mem_mb": peak / 2**20,
           "peak_mem_above_start_mb": (peak - mem_at_start) / 2**20,
           "launches": {"forward": counts[-1], "prefill": prefill_counts},
           "checks": checks}
    log(rec)
    del model
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"audio_encode: failed {failed}")
    return rec


# ---------------------------------------------------------------------------
# phases 16-17: the paper's harness and the bench suite
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# LM training: the attention backward, the train step at full width
# ---------------------------------------------------------------------------

# the attention backward at the attention families' in-model shapes (name,
# B, T, H, Hkv, D, window, causal): smollm-135m's train step (a client's
# microbatch of 2 x 4,096 tokens, 9 heads over 3), internvl2-1b (2 x
# [256 patches; 3,840 tokens], 14 heads over 2, GQA 7), hubert-xlarge's
# encoder (2 x 1,500 frames, 16 heads, D = 80, bidirectional), and
# mixtral-shaped windowed rows (12 query heads over 2, T = 8,192, W =
# 4,096)
SWA_BWD_SHAPES = (("smollm-135m", 2, 4096, 9, 3, 64, None, True),
                  ("internvl2-1b", 2, 4096, 14, 2, 64, None, True),
                  ("hubert-xlarge", 2, 1500, 16, 16, 80, None, False),
                  ("mixtral-8x22b", 1, 8192, 12, 2, 128, 4096, True))
SWA_BWD_TIMING_RUNS = 20


def swa_bwd_work(rows, t, d, window, causal, itemsize, dev):
    """The backward's work over ``rows`` rows of a T = S band: (pairs
    inside the band, operations at 10 D a pair (the five products), at 14
    D (as run: the dQ pass recomputes S and dP), bytes: q, k, v, out, dout
    and the f32 log-sum-exp read once, dq, dk, dv written once)."""
    from repro_torch.kernels import swa_attention as sw
    pairs = rows * int(sw.band_mask(t, t, window, causal, dev).sum())
    nbytes = itemsize * 8 * rows * t * d + 4 * rows * t
    return pairs, 10 * d * pairs, 14 * d * pairs, nbytes


def swa_bwd_parity(dev, bw, flops, tf32):
    """The attention backward against its twin at each SWA_BWD_SHAPES
    entry, f32 (rtol = atol = 3e-5) and bf16 (rtol 1e-2, atol 1e-3: the
    outputs are rounded to bf16 from f32 sums, at most one bf16 step,
    2^-7 of the value, apart), the inputs as the model hands them (the GQA
    repeat through ops.swa_layout; out and the log-sum-exp from the forward
    kernel; dout from a seed), two calls bit-identical; the forward's
    log-sum-exp against the twin's, and its output bit-equal to the serving
    call's. Then, f32, the kernel, the twin and SDPA's backward (the
    efficient backend forced, through autograd, on the same repeated rows;
    is_causal, the band's mask, or none) timed against the bound: the
    larger of the bytes and 10 D operations a pair in f32-accurate 3xTF32
    (495 / 3 TFLOP/s on an H100), as the forward's bound is. Beside it the
    same operations on the CUDA cores, and the 14 D the kernel runs in
    3xTF32 (``bound_as_run_ms``). In bf16, the kernel and SDPA's bf16
    backward (the flash backend where the band is causal or absent, the
    efficient one with the band's mask) against the bf16 bound: the
    bytes, or the five products at the bf16 rate (990 TFLOP/s) with the
    three that take a split P or dS counted twice (16 D a pair; the kernel
    runs 20 D, its dQ pass recomputing S and dP)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    flush = l2_flush(dev)
    out_recs = []
    for name, b, t, h, hkv, d, window, causal in SWA_BWD_SHAPES:
        rec = {"model": name, "shape": [b * h, t, d], "kv_heads": hkv,
               "window": window, "causal": causal}
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            q, k, v = ops.swa_layout(*swa_inputs(dev, b, t, h, hkv, d,
                                                 dtype, t + h + d))
            out, lse = sw.swa_attention_cuda(q, k, v, window=window,
                                             causal=causal, return_lse=True)
            if not torch.equal(out, sw.swa_attention_cuda(
                    q, k, v, window=window, causal=causal)):
                raise AssertionError(f"swa_attention {name} {key}: the "
                                     f"output with the log-sum-exp differs")
            _, want_lse = sw.swa_attention_plain(q, k, v, window=window,
                                                 causal=causal,
                                                 return_lse=True)
            lse_err = float((lse - want_lse).abs().max())
            torch.testing.assert_close(lse, want_lse, rtol=3e-5, atol=3e-5)
            gen = torch.Generator(device=dev).manual_seed(t + d)
            dout = torch.randn(out.shape, generator=gen,
                               device=dev).to(dtype)
            args = (q, k, v, out, dout, lse)
            kw = dict(window=window, causal=causal)
            got = sw.swa_attention_bwd_cuda(*args, **kw)
            again = sw.swa_attention_bwd_cuda(*args, **kw)
            want = sw.swa_attention_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            rtol, atol = ((3e-5, 3e-5) if dtype == torch.float32
                          else (1e-2, 1e-3))
            errs, share = {}, {}
            for gname, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
                torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                           atol=atol, msg=f"{name} {gname}")
                if not torch.equal(g, a):
                    raise AssertionError(f"swa_attention_bwd {name} {key}: "
                                         f"two calls differ in {gname}")
                off = (g.float() - w.float()).abs()
                errs[gname] = float(off.max())
                # the largest error as a share of its element's limit
                share[gname] = float((off / (atol + rtol * w.float().abs()))
                                     .max())
                del off
            rec[key] = {"max_abs_err": max(errs.values()), "by_output": errs,
                        "max_abs_want": {n: float(w.float().abs().max())
                                         for n, w in zip(("dq", "dk", "dv"),
                                                         want)},
                        "share_of_limit": share, "rtol": rtol, "atol": atol,
                        "lse_max_abs_err": lse_err,
                        "bit_identical_on_repeat": True}
            pairs, ops10, ops14, nbytes = swa_bwd_work(
                b * h, t, d, window, causal, q.element_size(), dev)
            mask = None if window is None else sw.band_mask(
                t, t, window, causal, dev)
            backend = (SDPBackend.FLASH_ATTENTION
                       if dtype == torch.bfloat16 and mask is None
                       else SDPBackend.EFFICIENT_ATTENTION)
            leaves = [x.view(1, b * h, t, d).detach().requires_grad_()
                      for x in (q, k, v)]
            with sdpa_kernel(backend):
                lib_out = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask,
                    is_causal=causal and window is None)
            d4 = dout.view(1, b * h, t, d)

            def library():
                return torch.autograd.grad(lib_out, leaves, d4,
                                           retain_graph=True)

            lib_err = max(float((x.view(b * h, t, d).float() - g.float())
                                .abs().max())
                          for x, g in zip(library(), got))
            runs = SWA_BWD_TIMING_RUNS
            if dtype == torch.bfloat16:
                ops16 = 16 * d * pairs
                rec[key].update(
                    ms=time_ms(lambda: sw.swa_attention_bwd_cuda(*args, **kw),
                               flush, runs),
                    library_ms=time_ms(library, flush, runs),
                    library_backend=str(backend).split(".")[-1],
                    library_max_abs_diff_vs_kernel=lib_err,
                    flops_counted=ops16, bytes_counted=nbytes,
                    **_bound(nbytes, ops16, bw, 2 * tf32))
            else:
                rec.update(
                    ms=time_ms(lambda: sw.swa_attention_bwd_cuda(*args, **kw),
                               flush, runs),
                    plain_ms=time_ms(lambda: sw.swa_attention_bwd_plain(
                        *args, **kw), flush, runs),
                    library_ms=time_ms(library, flush, runs),
                    library="autograd of F.scaled_dot_product_attention("
                            "q, k, v, is_causal | attn_mask=band) on (1, "
                            "rows, T, D)",
                    library_backend="EFFICIENT_ATTENTION",
                    library_max_abs_diff_vs_kernel=lib_err,
                    forward_ms=time_ms(lambda: sw.swa_attention_cuda(
                        q, k, v, window=window, causal=causal,
                        return_lse=True), flush, runs),
                    pairs=pairs, flops_counted=ops10, bytes_counted=nbytes,
                    bound_cuda_cores_ms=max(nbytes / bw, ops10 / flops) * 1e3,
                    bound_as_run_ms=max(nbytes / bw, 3 * ops14 / tf32) * 1e3,
                    **_bound(nbytes, 3 * ops10, bw, tf32))
            del leaves, lib_out, q, k, v, out, lse, dout, got, again, want
        log({"phase": "swa_bwd", **rec})
        out_recs.append(rec)
    return out_recs


TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "smollm-135m", 4096, 8
# lr 0.1: at random init the loss (about ln V + 0.11, the logits' spread)
# moves by ~1e-3 a round; at 0.5 it rose (PERF.md §6)
TRAIN_K, TRAIN_M, TRAIN_ROUNDS, TRAIN_LR, TRAIN_SIGMA = 4, 2, 3, 0.1, 1e-4
# each round's participants: client 3 straggles in round 0, client 1 in
# round 1, none in round 2
TRAIN_MASKS = ((1, 1, 1, 0), (1, 0, 1, 1), (1, 1, 1, 1))
# the kernels' gradients against the twin's, per leaf (2-norm): far above
# f32 sums taken in another order, far below a kernel output off by a
# tile or a factor
TRAIN_GRAD_RTOL = 1e-4
TRAIN_POWER = 15.0
# the demo CLI: rounds, local steps, clients
TRAIN_CLI = (3, 2, 2)


def train_bounds(cfg, n_params, mb, per_step, flops, tf32):
    """A client step's least time in f32 at mb x TRAIN_SEQ tokens: 6 N
    operations a token (the products' forward and backward) on the CUDA
    cores, as the f32 run (TF32 off) does them; beside it the same plus
    the hand-written kernels' work in 3xTF32, as their own bounds count it
    (and all on the CUDA cores): the attention band (4 D a pair forward,
    10 D backward) per ``swa_attention`` launch of ``per_step``, the SSD
    intra-chunk part (``ssd_work`` forward, ``ssd_bwd_work`` backward) per
    ``ssd_chunk`` launch."""
    t = TRAIN_SEQ
    dense = 6 * n_params * mb * t
    attn = ssd = 0
    if per_step.get("swa_attention"):
        attn = (per_step["swa_attention"] * mb * cfg.num_heads
                * (t * (t + 1) // 2) * 14 * cfg.head_dim)
    if per_step.get("ssd_chunk"):
        q = min(cfg.ssm_chunk, t)
        shape = (mb * -(-t // q), cfg.ssm_nheads, cfg.ssm_ngroups, q,
                 cfg.ssm_state, cfg.ssm_head_dim, 4)
        fwd_cuda, fwd_mma, _ = ssd_work(*shape)
        ssd = per_step["ssd_chunk"] * (fwd_cuda + fwd_mma
                                       + ssd_bwd_work(*shape)[0])
    kernels = attn + ssd
    return {"client_step_bound_ms": dense / flops * 1e3,
            "client_step_bound_with_kernels_ms": (
                dense / flops + 3 * kernels / tf32) * 1e3,
            "client_step_bound_with_kernels_cuda_cores_ms": (
                dense + kernels) / flops * 1e3,
            "flops_6n_tokens": dense, "flops_attention": attn,
            "flops_ssd": ssd}


def train_profile(dev):
    """One client step of smollm-135m and one of mamba2-370m (lm_train's
    and ssm_train's: f32, a microbatch of 2 x 4,096 tokens, K = 1, M = 1)
    under torch.profiler, each after a warm-up: device time by kernel
    (``profile_client_step``; for mamba2-370m the SSD backward's share)
    beside the step's host-clock time. Run last in the script (see
    ``lm_train``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import init_model
    recs = []
    for arch in (TRAIN_ARCH, SSM_ARCH):
        free_held(f"train_profile {arch}")
        cfg = get_config(arch)
        mb = TRAIN_BATCH // TRAIN_K
        model = init_model(cfg, seed=0, device=dev)
        client = steps.make_paota_train_step(
            model, InputShape("train_4k_b8", TRAIN_SEQ, mb, "train"), 1,
            lr=TRAIN_LR, local_steps=1, sigma_over_varsigma=TRAIN_SIGMA,
            noise=steps.KeyedNormal(0))
        store = steps.stack_params(model, 1)
        batch = {"tokens": torch.from_numpy(next(token_stream(
            cfg.vocab_size, mb, TRAIN_SEQ, 1, seed=0))["tokens"]).to(dev)
            .view(1, 1, mb, TRAIN_SEQ)}
        ones = torch.ones((1,), device=dev)
        client(store, batch, ones, ones, 0)             # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        client(store, batch, ones, ones, 1)
        torch.cuda.synchronize()
        rec = {"phase": "train_profile", "arch": arch,
               "client_step_ms": (time.perf_counter() - t0) * 1e3,
               **(profile_client_step(lambda: client(
                   store, batch, ones, ones, 2)) or {"device_ms": None})}
        if rec["device_ms"] and arch == SSM_ARCH:
            rec["ssd_bwd_share_of_device_time"] = (rec["ssd_bwd_ms"]
                                                   / rec["device_ms"])
        log(rec)
        recs.append(rec)
        del model, client, store, batch
    return recs


def profile_client_step(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    the total and the shares of the attention kernels, the GEMMs and the
    rest; None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        # the kernels' own events (an operator's row repeats its kernels')
        if not str(evt.device_type).endswith("CUDA"):
            continue
        self_us = getattr(evt, "self_device_time_total",
                          getattr(evt, "self_cuda_time_total", 0.0))
        if self_us > 0:
            rows.append((evt.key, self_us, evt.count))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)

    def share(*keys):
        return sum(r[1] for r in rows
                   if any(k in r[0].lower() for k in keys)) / 1e3

    return {"device_ms": total / 1e3,
            "swa_bwd_ms": share("swa_bwd"),
            "swa_fwd_ms": share("swa_attention_kernel"),
            "ssd_bwd_ms": share("ssd_bwd"),
            "ssd_bwd_by_kernel": {
                name: share(name) for name in (
                    "ssd_bwd_scores", "ssd_bwd_heads", "ssd_bwd_reduce")},
            "ssd_fwd_ms": share("ssd_grouped_kernel"),
            "gemm_ms": share("gemm", "sm90", "cutlass", "xmma", "sgemm"),
            "top": [{"kernel": k[:120], "ms": us / 1e3, "count": n}
                    for k, us, n in rows[:12]]}


class _ModelLoss(torch.nn.Module):
    """``loss_fn``'s cross-entropy of a wrapped model, for
    ``torch.func.functional_call`` with one client's params."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        from repro_torch.models.transformer import loss_fn
        return loss_fn(self.model, batch)[1]["loss"]


def loss_at(model, leaves, batch):
    """``loss_fn``'s cross-entropy on ``batch`` at one client's params
    (``leaves``, a row of the train store in its leaf order), no
    gradient."""
    from repro_torch.launch import steps
    mapping = steps.client_params(steps.param_layout(model), leaves, "model.")
    with torch.no_grad():
        return float(torch.func.functional_call(_ModelLoss(model), mapping,
                                                (batch,)))


def row(store, client):
    """``client``'s row of the train store, in its leaf order."""
    from repro_torch.tree import tree_leaves
    return [x[client] for x in tree_leaves(store)]


def twin_attention(q, k, v, *, window=None, causal=True):
    """``ops.swa_attention`` with the twin in place of the kernels, under
    torch's own autograd (the layout as ``ops.swa_attention``'s)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    b, t, h, d = q.shape
    out = sw.swa_attention_plain(*ops.swa_layout(q, k, v), window=window,
                                 causal=causal)
    return out.reshape(b, h, t, d).transpose(1, 2)


def ssd_twin(cum, b, c, xdt):
    """``ops.ssd_intra_chunk_grouped`` with the twin in place of the
    kernels, under torch's own autograd."""
    from repro_torch.kernels import ssd_chunk as sc
    return sc.ssd_intra_chunk_grouped_plain(cum, b, c, xdt)


def grads_vs_twin(model, leaves, batch, twins):
    """One client's loss gradients at full width through the kernels
    (forward and backward kernels) and through the twins under torch's
    autograd (``twins``: ops entry -> twin), on the same params and batch,
    both with block remat (so that the twins' (rows, T, T) matrices live
    one layer at a time): per leaf |g - g_twin| / |g_twin| (2-norms) and
    the losses."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, remat="block")
    layout = steps.param_layout(model)

    def run():
        own = [x.detach().clone().requires_grad_() for x in leaves]
        return torch.func.functional_call(
            steps._ClientLoss(model), steps.client_params(layout, own,
                                                          "model."),
            (batch, own))
    try:
        loss, got = run()
        with contextlib.ExitStack() as stack:
            for name, fn in twins.items():
                stack.enter_context(mock.patch.object(ops, name, fn))
            want_loss, want = run()
    finally:
        model.cfg = cfg
    rel = [float((g - w).norm() / w.norm().clamp_min(1e-30))
           for g, w in zip(got, want)]
    return {"rel_l2_by_leaf": rel, "max_rel_l2": max(rel),
            "twins": sorted(twins), "loss": float(loss),
            "loss_twin": float(want_loss),
            "grad_norm": float(torch.stack([g.norm() for g in got]).norm())}


def train_round(step, store, batch, powers, mask, r):
    """One train round with the counters at 0 before and read after:
    (store, the round's record with its launches)."""
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    store, met = step(store, batch, powers, mask, r)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return store, {"round": r, "ms": ms, "loss": float(met["loss"]),
                   "varsigma": float(met["varsigma"]),
                   "participants": float(met["participants"]),
                   "launches": read_counters()}


def finish(rec):
    """Log a phase's record; raise if any of its checks failed."""
    log(rec)
    failed = [c for c, ok in rec["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"{rec['phase']}: failed {failed}")
    return rec


def paota_train(dev, phase, arch, cfg, *, k, m, mb, rounds, masks, per_step,
                twins, flops, tf32, bf16_round=True, after_rounds=None):
    """PAOTA training of ``cfg`` on the card as a user runs it
    (``launch.steps.make_paota_train_step``): f32, TF32 off, random weights
    from seed 0, ``k`` clients of ``m`` local SGD steps on ``mb`` x
    TRAIN_SEQ tokens each, ``rounds`` rounds with ``masks[r]``'s
    participants, lr TRAIN_LR, sigma_over_varsigma TRAIN_SIGMA (so sweep 2
    runs). Counters at 0 before each round and read after: ``per_step``
    (kernel -> launches) per client step, one sweep 2 per reference leaf a
    round, nothing else. Checks: the loss finite and, over two rounds or
    more, the last round's below the first's; the store finite; the
    participants' rows equal and a straggler's its own; round 0's
    stragglers (which keep their local params) lower on each of their own
    microbatches after their local steps than before; client 0's
    first-microbatch gradients at the initial params per leaf within
    TRAIN_GRAD_RTOL (2-norm) of the same with ``twins``
    (``grads_vs_twin``). A held-out batch's loss is logged before and after
    each round. ``after_rounds(model, store, powers, masks)``, where given,
    runs on the last round's store and returns fields for the record. With
    ``bf16_round``, one round in bf16 under ``runtime_config`` (block
    remat: each forward kernel twice a step) on round 0's batch, its loss
    within 2e-2 of the f32 round's. Returns the record; ``finish`` enforces
    its checks."""
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import init_model, param_count
    from repro_torch.tree import tree_leaves
    free_held(phase)
    t_phase = time.perf_counter()
    shape = InputShape("train_4k", TRAIN_SEQ, k * mb, "train")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    store = steps.stack_params(model, k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    n_leaves = len(tree_leaves(store))
    store_mb = sum(x.numel() * x.element_size()
                   for x in tree_leaves(store)) / 2**20
    batches = [torch.from_numpy(b["tokens"].reshape(k, m, mb, TRAIN_SEQ))
               .to(dev) for b in token_stream(cfg.vocab_size, k * m * mb,
                                              TRAIN_SEQ, rounds, seed=0)]
    held = {"tokens": torch.from_numpy(next(token_stream(
        cfg.vocab_size, mb, TRAIN_SEQ, 1, seed=1))["tokens"]).to(dev)}
    powers = torch.full((k,), TRAIN_POWER, device=dev)
    mask_t = [torch.tensor(x, dtype=torch.float32, device=dev)
              for x in masks]
    step = steps.make_paota_train_step(
        model, shape, k, lr=TRAIN_LR, local_steps=m,
        sigma_over_varsigma=TRAIN_SIGMA, noise=steps.KeyedNormal(0))
    stragglers = [i for i, on in enumerate(masks[0]) if not on]
    theta0 = {i: [x.clone() for x in row(store, i)] for i in stragglers}
    want = dict({n: k * m * c for n, c in per_step.items()},
                superpose_normalize=n_leaves)
    held_losses = [loss_at(model, row(store, 0), held)]
    recs, checks = [], {}
    for r in range(rounds):
        store, rnd = train_round(step, store, {"tokens": batches[r]}, powers,
                                 mask_t[r], r)
        recs.append(rnd)
        held_losses.append(loss_at(model, row(store, 0), held))
        if r == 0:
            theta1 = {i: [x.clone() for x in row(store, i)]
                      for i in stragglers}
        emb = store["embedding"]["embed"]
        on = [i for i, x in enumerate(masks[r]) if x]
        off = [i for i, x in enumerate(masks[r]) if not x]
        checks[f"round {r}: launches"] = rnd["launches"] == dict(
            {n: 0 for n in rnd["launches"]}, **want)
        checks[f"round {r}: participants share the aggregate"] = all(
            bool(torch.equal(emb[i], emb[on[0]])) for i in on)
        checks[f"round {r}: a straggler keeps its own"] = all(
            not bool(torch.equal(emb[i], emb[on[0]])) for i in off)
    losses = [x["loss"] for x in recs]
    checks["loss finite"] = all(np.isfinite(losses))
    if rounds > 1:
        checks["loss falling: last round below the first"] = (
            losses[-1] < losses[0])
    checks["store finite"] = all(bool(torch.isfinite(x).all())
                                 for x in tree_leaves(store))
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    own = {i: [{"tokens": batches[0][i, j]} for j in range(m)]
           for i in stragglers}
    straggler = [{"client": i,
                  "before": [loss_at(model, theta0[i], b) for b in own[i]],
                  "after": [loss_at(model, theta1[i], b) for b in own[i]]}
                 for i in stragglers]
    if stragglers:
        checks["straggler: loss drops on each own microbatch"] = all(
            a < b for s in straggler for a, b in zip(s["after"],
                                                     s["before"]))
    extra = after_rounds(model, store, powers, mask_t) if after_rounds else {}
    del theta0, theta1, own, store, step
    grads = grads_vs_twin(model, row(steps.stack_params(model, 1), 0),
                          {"tokens": batches[0][0, 0]}, twins)
    checks[f"gradients within {TRAIN_GRAD_RTOL} of the twins' "
           f"({', '.join(sorted(twins))})"] = (
        grads["max_rel_l2"] <= TRAIN_GRAD_RTOL)
    del model
    bf16 = None
    if bf16_round:
        free_held(f"{phase} bf16")
        model16 = init_model(steps.runtime_config(cfg), seed=0, device=dev)
        step16 = steps.make_paota_train_step(
            model16, shape, k, lr=TRAIN_LR, local_steps=m,
            sigma_over_varsigma=TRAIN_SIGMA, noise=steps.KeyedNormal(0))
        store16, bf16 = train_round(step16, steps.stack_params(model16, k),
                                    {"tokens": batches[0]}, powers,
                                    mask_t[0], 0)
        bf16["dtype"] = str(tree_leaves(store16)[0].dtype).split(".")[-1]
        bf16["rel_diff_vs_f32_round0"] = abs(bf16["loss"] - losses[0]) / abs(
            losses[0])
        checks["bf16 round: loss within 2e-2 of f32"] = (
            np.isfinite(bf16["loss"])
            and bf16["rel_diff_vs_f32_round0"] <= 2e-2)
        checks["bf16 round: launches (remat: forward twice)"] = (
            bf16["launches"] == dict(
                {n: 0 for n in bf16["launches"]},
                **{n: (1 if n.endswith("_bwd") else 2) * k * m * c
                   for n, c in per_step.items()},
                superpose_normalize=n_leaves))
        checks["bf16 round: store stays bf16"] = bf16["dtype"] == "bfloat16"
        del store16, model16, step16
    del batches
    return {"phase": phase, "arch": arch, "params": n_params,
            "layers": cfg.num_layers, "dtype": "float32", "clients": k,
            "local_steps": m, "microbatch": mb, "seq_len": TRAIN_SEQ,
            "lr": TRAIN_LR, "sigma_over_varsigma": TRAIN_SIGMA,
            "masks": masks, "launches_per_client_step": per_step,
            "leaves": n_leaves, "store_mb": store_mb, "init_s": init_s,
            "peak_mb_above_start": peak_mb, "rounds": recs,
            "losses": losses, "held_out_losses": held_losses,
            "straggler_own_losses": straggler, "grads_vs_twin": grads,
            "round_ms_per_client_step": [x["ms"] / (k * m) for x in recs],
            "bf16_round": bf16, **extra,
            **train_bounds(cfg, n_params, mb, per_step, flops, tf32),
            "seconds": time.perf_counter() - t_phase, "checks": checks}


def train_aggregation(dev, bw, model, store, powers, masks):
    """The aggregation of a train store (round 0's mask, zero noise) timed,
    and sweep 2 at each of its leaf widths against its twin (3e-5), timed
    beside the twin, ``mv`` and the bound."""
    from repro_torch.core.aggregation import paota_aggregate_stacked
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.tree import tree_leaves
    k = powers.numel()
    agg_ms = time_ms(lambda: paota_aggregate_stacked(
        store, powers, masks[0], torch.zeros(
            sum(x[0].numel() for x in tree_leaves(store)), device=dev)),
        l2_flush(dev), 5)
    sweep2 = []
    flush = l2_flush(dev)
    for leaf in tree_leaves(store):
        x = leaf.reshape(k, -1)
        nz = torch.zeros(x.shape[1], device=dev)
        nbytes = 4 * (x.numel() + 2 * x.shape[1])
        got, _ = ac.superpose_normalize_cuda(x, powers, masks[0], nz)
        want, _ = ac.superpose_normalize_plain(x, powers, masks[0], nz)
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
        sweep2.append({"shape": list(x.shape),
                       "max_abs_err": float((got - want).abs().max()),
                       "ms": time_ms(lambda: ac.superpose_normalize_cuda(
                           x, powers, masks[0], nz), flush, 20),
                       "plain_ms": time_ms(
                           lambda: ac.superpose_normalize_plain(
                               x, powers, masks[0], nz), flush, 20),
                       "yardstick_ms": time_ms(lambda: torch.mv(
                           x.t(), powers * masks[0]), flush, 20),
                       "bound_ms": nbytes / bw * 1e3})
    return {"aggregate_ms": agg_ms, "sweep2_by_leaf": sweep2}


def lm_train(dev, bw, flops, tf32):
    """smollm-135m's PAOTA training at full width on the card
    (``paota_train``): the reference's train_4k length (4,096) with the
    global batch cut from 256 to 8 (K = 4, mb = 2 a client), M = 2 local
    steps, 3 rounds with TRAIN_MASKS' stragglers; per client step one
    forward and one backward attention launch a layer; gradients against
    the attention twin; a bf16 round. Then the aggregation and sweep 2 at
    the store's leaf widths timed (``train_aggregation``), reduced mamba2
    trains on the card (one round, both SSD kernels once a layer), and the
    train CLI's demo. The timed and profiled single client step is
    ``train_profile``, which main runs last, so that the profiler cannot
    slow the phases after it."""
    import io
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import init_model
    cfg = get_config(TRAIN_ARCH)
    layers = cfg.num_layers
    rec = paota_train(
        dev, "lm_train", TRAIN_ARCH, cfg, k=TRAIN_K, m=TRAIN_M,
        mb=TRAIN_BATCH // TRAIN_K, rounds=TRAIN_ROUNDS, masks=TRAIN_MASKS,
        per_step={"swa_attention": layers, "swa_attention_bwd": layers},
        twins={"swa_attention": twin_attention}, flops=flops, tf32=tf32,
        after_rounds=lambda *a: train_aggregation(dev, bw, *a))
    checks = rec["checks"]

    # reduced mamba2 trains on the card, through both SSD kernels
    ssm = init_model(get_reduced(SSM_ARCH), seed=0, device=dev)
    ssm_step = steps.make_paota_train_step(
        ssm, InputShape("t", 40, 2, "train"), 1, lr=TRAIN_LR, local_steps=1)
    ones = torch.ones((1,), device=dev)
    zero_counters()
    _, ssm_met = ssm_step(steps.stack_params(ssm, 1), {"tokens": torch.zeros(
        (1, 1, 2, 40), dtype=torch.int32, device=dev)}, ones, ones, 0)
    torch.cuda.synchronize()
    ssm_counts = read_counters(("ssd_chunk", "ssd_chunk_bwd"))
    checks["reduced mamba2 trains on the card"] = bool(
        torch.isfinite(ssm_met["loss"])) and ssm_counts == {
            "ssd_chunk": ssm.cfg.num_layers,
            "ssd_chunk_bwd": ssm.cfg.num_layers}
    del ssm, ssm_step

    # the train CLI's demo (reduced smollm, block remat)
    rounds_cli, m_cli, k_cli = TRAIN_CLI
    buf = io.StringIO()
    zero_counters()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--demo", "--rounds", str(rounds_cli),
                        "--local-steps", str(m_cli), "--clients",
                        str(k_cli)])
    cli_counts = read_counters()
    lines = buf.getvalue().splitlines()
    cli_losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
                  if ln.startswith("round ")]
    checks["cli: a finite loss a round"] = (
        len(cli_losses) == rounds_cli and all(np.isfinite(cli_losses)))
    checks["cli: loss falling"] = cli_losses[-1] < cli_losses[0]
    red = get_reduced(TRAIN_ARCH)
    checks["cli: kernels launched"] = (
        cli_counts["swa_attention_bwd"] == rounds_cli * k_cli * m_cli
        * red.num_layers and cli_counts["superpose_normalize"] > 0)
    rec["cli"] = {"argv": ["--demo", "--rounds", rounds_cli,
                           "--local-steps", m_cli, "--clients", k_cli],
                  "stdout": lines, "losses": cli_losses,
                  "launches": cli_counts}
    return finish(rec)


# the SSD backward's cases (name, Bz, NC, Q, H, G, N, P, offset of B in a
# conv output or None for contiguous B and C, the log-decay's steepness):
# mamba2-370m's train microbatch (2 x 4,096 tokens) and zamba2-7b's (1 x
# 4,096) on strided views of their conv outputs as the models hand them
# over, two groups, ragged Q / N / P on views whose rows are no 16-byte
# multiple, and log-decays steep enough that the -60 clip binds
SSD_BWD_CASES = (("mamba2-370m", 2, 16, 256, 32, 1, 128, 64, 2048, 0.2),
                 ("zamba2-7b", 1, 16, 256, 112, 1, 64, 64, 7168, 0.2),
                 ("groups", 2, 4, 256, 8, 2, 64, 64, None, 0.2),
                 ("ragged", 1, 3, 100, 8, 2, 40, 70, 3, 0.2),
                 ("clip", 1, 4, 256, 4, 1, 64, 64, None, 1.0))
SSD_BWD_TIMING_RUNS = 20


def ssd_bwd_work(cells, h, g, q, n, p, itemsize):
    """The SSD backward's work as its inputs need it: (operations,
    operations as bf16 tensor-core products count them, bytes). Over the
    causal half (i >= j): per cell and group S = C B^T, (sum dS) B and
    (sum dS)^T C, 2 N a pair each; per head dM and M^T dy, 2 P a pair
    each, and the pair's dS, M, dS * S, its two sums (5 a pair); per head
    B dstate^T and xdt dstate (2 Q N P each) and the tail terms (3 Q P).
    In bf16, a product with an operand that is no bf16 input (sum dS, M,
    the f32 dstate) is counted twice, split hi + lo as the attention
    backward's P and dS are. Each input read once (cum, B, C, xdt, dy,
    dstate, ddecay), each output written once (dcum, dB, dC, dxdt)."""
    pairs = q * (q + 1) // 2
    ops = cells * (g * pairs * 6 * n
                   + h * (pairs * (4 * p + 5) + 4 * q * n * p + 3 * q * p))
    ops16 = cells * (g * pairs * 10 * n
                     + h * (pairs * (6 * p + 5) + 8 * q * n * p + 3 * q * p))
    nbytes = (8 * cells * q * h + 4 * itemsize * cells * q * g * n
              + 3 * itemsize * cells * q * h * p + 4 * cells * h * (p * n + 1))
    return ops, ops16, nbytes


def ssd_bwd_parity(dev, bw, flops, tf32):
    """The SSD backward kernel against its twin at each SSD_BWD_CASES
    entry (inputs from ``ssd_chunk.grouped_bwd_example``), f32 within 2e-5
    and bf16 within 2e-2 of each gradient's largest |value| where that
    exceeds 1 (dcum sums up to Q^2 terms a row; the reference's SSD
    tolerance), two calls bit-identical. Timed (f32 and bf16) beside the
    twin and the forward kernel against the bound: the larger of the bytes
    and the operations, in f32 in f32-accurate 3xTF32 (495 / 3 TFLOP/s on
    an H100) as the attention backward's bound is and as the kernel runs
    every product (``bound_as_run_ms``), with the CUDA cores' rate beside
    it (``bound_cuda_cores_ms``); in bf16 at the bf16 rate (990 TFLOP/s),
    products with an f32 operand counted twice, as the kernel splits that
    operand into bf16 hi + lo. Each record names the staging the case's
    strides choose (``ssd_chunk._bwd_vec16``: 16-byte cp.async or plain
    loads) and the launches' blocks (``ssd_chunk.bwd_blocks``). Library:
    none; cuBLAS's bmm of the group's dS with B stands as a partial
    yardstick, as bmm(C, B^T) does for the forward."""
    from repro_torch.kernels import ssd_chunk as sc
    flush = l2_flush(dev)
    recs = []
    for name, bz, nc, q, h, g, n, p, offset, steep in SSD_BWD_CASES:
        t0 = time.perf_counter()
        rec = {"case": name, "model": (name if name in (SSM_ARCH, HYBRID_ARCH)
                                      else f"synthetic ({name})"), "shape": {
            "Bz": bz, "NC": nc, "Q": q, "H": h, "G": g, "N": n, "P": p},
            "b_c_views_of_conv_output": offset is not None, "kv_heads": None,
            "causal": True, "library": "none", "library_ms": None,
            "products": "mma.sync: 3xTF32 m16n8k8 (f32); bf16 m16n8k16, "
                        "f32 operands split into bf16 hi + lo (bf16)",
            "blocks": sc.bwd_blocks(bz, nc, q, h, g, n, p)}
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            args = sc.grouped_bwd_example(
                bz, nc, q, h, g, n, p, offset=offset, steep=steep,
                dtype=dtype, seed=q + h + n + p, device=dev)
            rec[f"staging_{key}"] = ("cp.async" if sc._bwd_vec16(*args[1:6])
                                     else "plain loads")
            # views 3 elements into the conv output take plain loads
            if rec[f"staging_{key}"] != ("plain loads" if offset == 3
                                         else "cp.async"):
                raise AssertionError(f"ssd_bwd {name} {key}: staged by "
                                     f"{rec[f'staging_{key}']}")
            if name == "clip":
                cum = args[0]
                rec["clip_binds"] = bool(
                    (cum[:, :, -1] - cum[:, :, 0] < -60.0).any())
            got = sc.ssd_intra_chunk_grouped_bwd_cuda(*args)
            again = sc.ssd_intra_chunk_grouped_bwd_cuda(*args)
            want = sc.ssd_intra_chunk_grouped_bwd_plain(*args)
            torch.cuda.synchronize()
            tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
            errs, wmax = {}, {}
            for gname, a, b2, w in zip(("dcum", "db", "dc", "dxdt"), got,
                                       again, want):
                scale = max(1.0, float(w.float().abs().max()))
                torch.testing.assert_close(
                    a.float(), w.float(), rtol=tol, atol=tol * scale,
                    msg=f"ssd_bwd {name} {key} {gname}")
                if not torch.equal(a, b2):
                    raise AssertionError(f"ssd_bwd {name} {key}: two calls "
                                         f"differ in {gname}")
                errs[gname] = float((a.float() - w.float()).abs().max())
                wmax[gname] = float(w.float().abs().max())
            nops, nops16, nbytes = ssd_bwd_work(bz * nc, h, g, q, n, p,
                                                args[3].element_size())
            sub = {"max_abs_err": max(errs.values()), "by_output": errs,
                   "max_abs_want": wmax,
                   "max_rel_err": max(errs[k] / max(1.0, wmax[k])
                                      for k in errs),
                   "tol_relative_to_max": tol,
                   "bit_identical_on_repeat": True,
                   "ms": time_ms(lambda: sc.ssd_intra_chunk_grouped_bwd_cuda(
                       *args), flush, SSD_BWD_TIMING_RUNS),
                   "library_ms": None, "bytes_counted": nbytes}
            if dtype == torch.bfloat16:
                sub.update(flops_counted=nops16,
                           **_bound(nbytes, nops16, bw, 2 * tf32))
            else:
                cum, b, c, xdt = args[:4]
                cells = bz * nc * g
                dsg = torch.randn((cells, q, q), device=dev)
                bg = torch.randn((cells, q, n), device=dev)
                cuda_cores = max(nbytes / bw, nops / flops) * 1e3
                sub.update(flops_counted=nops,
                           **_bound(nbytes, 3 * nops, bw, tf32))
                rec.update(
                    ms=sub["ms"],
                    plain_ms=time_ms(
                        lambda: sc.ssd_intra_chunk_grouped_bwd_plain(*args),
                        flush, SSD_BWD_TIMING_RUNS),
                    forward_ms=time_ms(
                        lambda: sc.ssd_intra_chunk_grouped_cuda(cum, b, c,
                                                                xdt),
                        flush, SSD_BWD_TIMING_RUNS),
                    yardstick_ms=time_ms(lambda: torch.bmm(dsg, bg), flush,
                                         SSD_BWD_TIMING_RUNS),
                    yardstick="torch.bmm(sum_h dS, B) per group (partial: "
                              "one of the backward's products, full Q x Q)",
                    bound_cuda_cores_ms=cuda_cores,
                    bound_as_run_ms=sub["bound_ms"],
                    bound_ms=sub["bound_ms"], bound_by=sub["bound_by"])
                del dsg, bg
            rec[key] = sub
            del args, got, again, want
        rec["seconds"] = time.perf_counter() - t0
        log({"phase": "ssd_bwd", **rec})
        recs.append(rec)
    if not recs[-1]["clip_binds"]:
        raise AssertionError("ssd_bwd: the clip case's log-decays never "
                             "pass -60")
    return recs


SSM_ARCH = "mamba2-370m"
# zamba2-7b at full width, its depth cut to fit one card in training: 12
# of 81 layers (the shared block at 2 of its 14 slots); K = 2 clients, M =
# 1 local step, a microbatch of 1 x 4,096 tokens, 1 round
HYBRID_ARCH, HYBRID_LAYERS = "zamba2-7b", 12
HYBRID_K, HYBRID_M, HYBRID_MB, HYBRID_ROUNDS = 2, 1, 1, 1
HYBRID_MASK = (1, 1)


def ssm_train(dev, bw, flops, tf32):
    """mamba2-370m's PAOTA training at full width on the card (48 layers,
    d_model 1,024, vocab 50,280, tied; ``paota_train``), as ``lm_train``
    trains smollm-135m: K = 4, M = 2, 2 x 4,096 tokens a client, 3 rounds
    with TRAIN_MASKS' stragglers; per client step one ``ssd_chunk`` and
    one ``ssd_chunk_bwd`` launch a layer; gradients against the SSD twin's
    forward and backward; a bf16 round. The profiled client step is
    ``train_profile``'s, last."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH)
    layers = cfg.num_layers
    rec = paota_train(
        dev, "ssm_train", SSM_ARCH, cfg, k=TRAIN_K, m=TRAIN_M,
        mb=TRAIN_BATCH // TRAIN_K, rounds=TRAIN_ROUNDS, masks=TRAIN_MASKS,
        per_step={"ssd_chunk": layers, "ssd_chunk_bwd": layers},
        twins={"ssd_intra_chunk_grouped": ssd_twin}, flops=flops, tf32=tf32)
    rec["reduced"] = None
    return finish(rec)


def hybrid_train(dev, bw, flops, tf32):
    """zamba2-7b's PAOTA training on the card at its published width
    (d_model 3,584, 112 SSM heads, 32 attention heads of D 112, W 4,096)
    with its depth cut to HYBRID_LAYERS of 81 layers (the shared block at
    2 slots) to fit one card (``paota_train``): K = 2, M = 1, 1 x 4,096
    tokens a client, one round with both clients, no bf16 round; per
    client step one ``ssd_chunk`` and one ``ssd_chunk_bwd`` launch a
    layer, one ``swa_attention`` and one ``swa_attention_bwd`` a shared
    slot; gradients against both twins (SSD and attention)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import n_shared_slots
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS)
    slots = n_shared_slots(cfg)
    rec = paota_train(
        dev, "hybrid_train", HYBRID_ARCH, cfg, k=HYBRID_K, m=HYBRID_M,
        mb=HYBRID_MB, rounds=HYBRID_ROUNDS,
        masks=(HYBRID_MASK,) * HYBRID_ROUNDS,
        per_step={"ssd_chunk": HYBRID_LAYERS, "ssd_chunk_bwd": HYBRID_LAYERS,
                  "swa_attention": slots, "swa_attention_bwd": slots},
        twins={"swa_attention": twin_attention,
               "ssd_intra_chunk_grouped": ssd_twin},
        flops=flops, tf32=tf32, bf16_round=False)
    rec.update(shared_slots=slots, reduced={
        "num_layers": [HYBRID_LAYERS, full.num_layers],
        "shared_slots": [slots, n_shared_slots(full)],
        "why": "f32 training of the full depth needs more than one card's "
               "80 GB; width is as published"})
    return finish(rec)


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


def swa_work(rows, t, d, window, itemsize, dev, causal=True):
    """swa_attention's work over ``rows`` (batch x head) rows of a T = S =
    t band, causal or not: (pairs inside the band, operations at 4 D a
    pair, bytes with each input read once and each output written
    once)."""
    from repro_torch.kernels import swa_attention as sw
    pairs = rows * int(sw.band_mask(t, t, window, causal, dev).sum())
    return pairs, 4 * d * pairs, itemsize * 4 * rows * t * d


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
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as sw
    h, hkv, d = SWA_ZOO[name]
    t = SWA_TIME_T
    qf, kf, vf = ops.swa_layout(*swa_inputs(dev, 1, t, h, hkv, d, dtype, 3))
    mask = sw.band_mask(t, t, SWA_WINDOW, True, dev)
    pairs, nops, nbytes = swa_work(h, t, d, SWA_WINDOW, qf.element_size(),
                                   dev)
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


# ---------------------------------------------------------------------------
# the sharded round: 4 ranks over gloo on cuda:0 against the fused round
# ---------------------------------------------------------------------------

SHARDED_RANKS = 4
SHARDED_TOL = {"model": dict(rtol=1e-4, atol=1e-5),
               "delta": dict(rtol=1e-4, atol=5e-5)}
# (name, K, sizes, transmit, mesh, knobs, rounds, step, fused twin)
SHARDED_CASES = (
    ("flat_model", 100, "paper", "model", [("data", 4)], {}, 20, 1,
     "model"),
    ("flat_delta", 100, "paper", "delta", [("data", 4)], {}, 20, 1,
     "delta"),
    ("flat_k1000", 1000, "fast", "model", [("data", 4)], {}, 10, 1,
     "k1000"),
    ("pytree", 100, "paper", "model", [("data", 4)],
     {"params_mode": "pytree"}, 10, 1, "pytree"),
    ("phantoms_k102", 102, "paper", "model", [("data", 4)], {}, 10, 1,
     "k102"),
    ("grouped_n1", 100, "paper", "model", [("pod", 2), ("data", 2)],
     {"group_period": 1}, 10, 1, "model"),
    ("grouped_n4", 100, "paper", "model", [("pod", 2), ("data", 2)],
     {"group_period": 4}, 12, 4, None),
    ("tp_2x2", 100, "paper", "model", [("data", 2), ("tp", 2)],
     {"params_mode": "pytree"}, 10, 1, "pytree"),
    ("blackout", 100, "paper", "model", [("pod", 2), ("data", 2)],
     {"group_period": 2, "faults": {"pod_blackout": (1,),
                                    "blackout_start": 2,
                                    "blackout_stop": 5}}, 8, 2, None),
    # the sharded active cohort: m = K at K = 100 against the fused dense
    # round; at the cohort path's K = 1000, m = 64 (16 slots a rank), the
    # uncompressed and two compressed payloads
    ("cohort_full_k100", 100, "paper", "model", [("data", 4)],
     {"cohort_size": 100}, 10, 1, "model"),
    ("cohort_k1000_m64", COHORT_K, "fast", "delta", [("data", 4)],
     {"cohort_size": COHORT_M}, 10, 1, None),
    ("compressed_k1000_randmask", COHORT_K, "fast", "delta", [("data", 4)],
     {"cohort_size": COHORT_M, "compress": "randmask",
      "compress_ratio": 1 / 16}, 10, 1, None),
    ("compressed_k1000_topk_int8", COHORT_K, "fast", "delta", [("data", 4)],
     {"cohort_size": COHORT_M, "compress": "topk", "compress_ratio": 1 / 16,
      "slot_dtype": "int8"}, 10, 1, None))
# with no fused twin (m < K refills per rank) these run a second time in
# the same ranks on the plain twins, the kernel run's oracle every round;
# int8 top-k gets only the structural checks: its int8 floor turns ulp
# differences into steps (ROADMAP Queue 3 item 3)
SHARDED_TWIN_RERUN = ("cohort_k1000_m64", "compressed_k1000_randmask")
SHARDED_TWIN_TOL = dict(rtol=1e-4, atol=5e-5)
# kill at round `kill` of `rounds`, restore in fresh ranks, the rest
# bit-identical: (name, K, sizes, transmit, mesh, knobs, rounds, kill);
# the grouped case kills at a window boundary, inside pod 1's dark rounds
SHARDED_RESUME = (
    ("flat_faults_k100", 100, "paper", "model", [("data", 4)],
     {"faults": {"nan_frac": 0.1, "byzantine_frac": 0.1,
                 "deep_fade_frac": 0.1}, "screen": True}, 10, 5),
    ("grouped_blackout", 100, "paper", "model", [("pod", 2), ("data", 2)],
     {"group_period": 2, "faults": {"pod_blackout": (1,),
                                    "blackout_start": 3,
                                    "blackout_stop": 7}}, 10, 4),
    ("compressed_k1000_topk_int8", COHORT_K, "fast", "delta", [("data", 4)],
     {"cohort_size": COHORT_M, "compress": "topk", "compress_ratio": 1 / 16,
      "slot_dtype": "int8"}, 10, 5),
    ("tp_2x2", 100, "paper", "model", [("data", 2), ("tp", 2)],
     {"params_mode": "pytree"}, 10, 5))
# the partial entry's shapes on the sharded paths: a rank's rows of the
# raveled plane (K = 100 and 1000 over 4 ranks) and a TP rank's block of
# the MLP's first layer ((25, 784, 5) of (25, 784, 10): seg 5, pitch 10)
PARTIAL_SHAPES = ((25, 8070, 8070, 8070), (250, 8070, 8070, 8070),
                  (25, 3920, 5, 10))
# the compressed partial's: a rank's 16 of the cohort's 64 slots at K =
# 1000 (s = 504 of d = 8070), and its 64 of the state plane's 256
GS_PARTIAL_SHAPES = ((16, 504, 8070), (64, 1024, 16384))


def partial_times(dev, bw, flops):
    """Both partial entries against their twins at the sharded paths'
    shapes, bit-identical on repeat, timed beside the twin and a
    yardstick, their bounds their bytes over the card's rate. Returns
    {"aircomp_partial": [...], "gather_superpose_partial": [...]}."""
    flush = l2_flush(dev)
    return {"aircomp_partial": aircomp_partial_times(dev, bw, flops, flush),
            "gather_superpose_partial": gs_partial_times(dev, bw, flops,
                                                         flush)}


def gs_partial_times(dev, bw, flops, flush):
    """The compressed partial (``gather_superpose_partial``) against its
    twin at GS_PARTIAL_SHAPES, f32 / bf16 / int8 + scale, dead rows
    included: the sums divided by Σ bp within 3e-5 (f32, int8: exact
    values) / 2e-2 (bf16), Σ bp at 3e-5, bit-identical on repeat; timed
    beside the twin and the ``zeros`` + ``mul`` + ``index_add_`` composite
    (row 3's yardstick) with the Σ bp slot. Bytes: the values and indices
    once, bp (and the scales), the (d + 1,) buffer written."""
    from repro_torch.kernels import gather_superpose as gs
    recs = []
    for m, s, d in GS_PARTIAL_SHAPES:
        for dtype, with_scale in ((torch.float32, False),
                                  (torch.bfloat16, False),
                                  (torch.int8, True)):
            v, idx, bp, _, scale = gs_inputs(dev, m, s, d, dtype,
                                             with_scale, m * s + d)
            got, again, want = (torch.full((d + 1,), -7.0, device=dev)
                                for _ in range(3))
            gs.gather_superpose_partial_cuda(v, idx, bp, got, d=d,
                                             scale=scale)
            gs.gather_superpose_partial_cuda(v, idx, bp, again, d=d,
                                             scale=scale)
            gs.gather_superpose_partial_plain(v, idx, bp, want, d=d,
                                              scale=scale)
            torch.cuda.synchronize()
            vs = torch.clamp_min(want[-1], 1e-12)
            tol = (_tol(dtype) if dtype == torch.bfloat16
                   else dict(rtol=3e-5, atol=3e-5))
            torch.testing.assert_close(got[:d] / vs, want[:d] / vs, **tol)
            torch.testing.assert_close(got[-1], want[-1], rtol=3e-5,
                                       atol=0.0)
            if not torch.equal(got, again):
                raise AssertionError(f"gather_superpose_partial {m}x{s}: "
                                     f"a repeat differs")
            err = float(((got[:d] - want[:d]) / vs).abs().max())
            w = bp if scale is None else bp * scale
            idx64 = idx.long().reshape(-1)

            def composite():
                out = torch.zeros((d + 1,), device=dev)
                out[:d].index_add_(0, idx64,
                                   (w[:, None] * v.float()).reshape(-1))
                out[d] = bp.sum()
                return out
            nbytes = (m * s * (v.element_size() + 4)
                      + 4 * m * (1 if scale is None else 2) + 4 * (d + 1))
            nops = 2 * m * s + m
            rec = {"shape": [m, s, d], "dtype": str(dtype).replace(
                       "torch.", "") + (" + scale" if with_scale else ""),
                   "max_abs_err_over_varsigma": err,
                   "repeat_bit_identical": True,
                   "ms": time_ms(lambda: gs.gather_superpose_partial_cuda(
                       v, idx, bp, got, d=d, scale=scale), flush),
                   "plain_ms": time_ms(
                       lambda: gs.gather_superpose_partial_plain(
                           v, idx, bp, want, d=d, scale=scale), flush),
                   "yardstick_ms": time_ms(composite, flush),
                   "yardstick": "torch.zeros(d + 1); [:d].index_add_(0, "
                                "idx, (w[:, None] * v).flatten()); [d] = "
                                "bp.sum()",
                   "library_ms": None,
                   "bound_ms": max(nbytes / bw, nops / flops) * 1e3,
                   "bound_by": "bytes" if nbytes / bw >= nops / flops
                   else "operations"}
            log({"phase": "kernel_time", "kernel": "gather_superpose_partial",
                 **rec})
            recs.append(rec)
    return recs


def aircomp_partial_times(dev, bw, flops, flush):
    """The dense partial entry against its twin at the sharded paths'
    shapes, f32 and bf16 (3e-5 / 2e-2), bit-identical on repeat, timed
    beside the twin and ``torch.mv``; the bound is its bytes (x once, bp,
    the placed columns and the varsigma slot) over the card's rate."""
    from repro_torch.kernels import aircomp_sum as ac
    recs = []
    for k, d, seg, pitch in PARTIAL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(k + d)
            x = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            bp = 15.0 * torch.rand((k,), generator=gen, device=dev) * (
                torch.rand((k,), generator=gen, device=dev) < 0.5).float()
            n = (d // seg - 1) * pitch + seg + 1
            got, again, want = (torch.zeros((n,), device=dev)
                                for _ in range(3))
            ac.aircomp_partial_cuda(x, bp, got, seg=seg, pitch=pitch)
            ac.aircomp_partial_cuda(x, bp, again, seg=seg, pitch=pitch)
            ac.aircomp_partial_plain(x, bp, want, seg=seg, pitch=pitch)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = _tol(dtype) if dtype == torch.bfloat16 else dict(
                rtol=3e-5, atol=3e-5)
            torch.testing.assert_close(got, want, **tol)
            if not torch.equal(got, again):
                raise AssertionError(f"aircomp_partial {k}x{d}: a repeat "
                                     f"differs")
            nbytes = x.element_size() * k * d + 4 * (k + d + 1)
            nops = 2 * k * d + k
            xt = x.t()
            rec = {"shape": [k, d], "seg": seg, "pitch": pitch,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "repeat_bit_identical": True,
                   "ms": time_ms(lambda: ac.aircomp_partial_cuda(
                       x, bp, got, seg=seg, pitch=pitch), flush),
                   "plain_ms": time_ms(lambda: ac.aircomp_partial_plain(
                       x, bp, want, seg=seg, pitch=pitch), flush),
                   "library_ms": time_ms(
                       lambda: torch.mv(xt, bp.to(dtype)), flush),
                   "library": "torch.mv(x.t(), bp) (the sum only: no "
                              "placement, no varsigma slot)",
                   "bound_ms": max(nbytes / bw, nops / flops) * 1e3,
                   "bound_by": "bytes" if nbytes / bw >= nops / flops
                   else "operations"}
            log({"phase": "kernel_time", "kernel": "aircomp_partial",
                 **rec})
            recs.append(rec)
    return recs


def _sharded_case(case, fed, mesh, transmit, knobs, **kw):
    return {"name": case, "fed": fed, "mesh": mesh, "sched": SCHED,
            "chan": CHAN, "cfg": {"transmit": transmit, "seed": 0},
            "knobs": knobs, **kw}


def sharded(dev, data, tmpdir, name, smi):
    """The sharded round (``ShardedPAOTA``) on SHARDED_RANKS ranks that
    share cuda:0 over gloo (NCCL refuses two ranks on one device), every
    case of SHARDED_CASES in one group of ranks
    (``repro_torch.launch.sharded_cases``), each held against a
    single-process FusedPAOTA on the same CounterDraws round for round
    (rtol 1e-4 / atol 1e-5, delta 5e-5) or, where it has none (the m < K
    cohort), against its own rerun on the plain twins (SHARDED_TWIN_RERUN,
    rtol 1e-4 / atol 5e-5). The kernels are built before the ranks start,
    so each only loads them. Per case: the gap to its oracle, the ranks'
    globals bit-identical, the reducer's calls a round (and the
    model-sized ones), each rank's launches (sweep 1 and the dense partial
    once a leaf a round, or the compressed partial once a round; the
    fused sweep 2 and gather_superpose never), ms a round on rank 0 after
    the first step, labelled as what it is: 4 ranks sharing one H100 over
    gloo. The same group runs the million-client state plane on the
    sharded runtime and, for SHARDED_RESUME, each layout whole and again
    to its kill, saving; a fresh group restores each file and finishes,
    bit-identical. Last, ``fl_train --engine sharded`` with checkpoints
    and its resume (``sharded_cli``)."""
    from repro_torch.data.partition import FAST_SIZES, PAPER_SIZES
    from repro_torch.launch.mesh import start_ranks
    from repro_torch.launch.sharded_cases import run_cases
    from repro_torch.models.mlp import init_mlp_params
    from repro_torch.tree import tree_map
    from repro_torch.data.partition import partition_noniid
    t_phase = time.perf_counter()
    x, y, _, _ = data
    xp, yp = os.path.join(tmpdir, "x.npy"), os.path.join(tmpdir, "y.npy")
    np.save(xp, x)
    np.save(yp, y)
    feds, cases = {}, [{"name": "gloo_probe", "kind": "probe"}]

    def fed(k, sizes):
        key = f"{k}-{sizes}"
        if key not in feds:
            feds[key] = {"x_path": xp, "y_path": yp,
                         "parts": partition_noniid(
                             y, n_clients=k, seed=0,
                             sizes=PAPER_SIZES if sizes == "paper"
                             else FAST_SIZES)}
        return key

    for (case, k, sizes, transmit, mesh, knobs, rounds, step,
         _) in SHARDED_CASES:
        cases.append(_sharded_case(case, fed(k, sizes), mesh, transmit,
                                   knobs, rounds=rounds, step=step,
                                   twin_rerun=case in SHARDED_TWIN_RERUN))
    cases.append({"name": "state_plane_sharded", "kind": "state_plane",
                  "mesh": [("data", SHARDED_RANKS)], "k": PLANE_K,
                  "m": PLANE_M, "d": PLANE_D, "ratio": 1 / 16,
                  "slot_dtype": "int8", "rounds": PLANE_ROUNDS,
                  "chan": CHAN})
    resume = []
    for (case, k, sizes, transmit, mesh, knobs, rounds,
         kill) in SHARDED_RESUME:
        resume.append(_sharded_case(
            f"resume_{case}", fed(k, sizes), mesh, transmit, knobs,
            rounds=rounds, kill=kill,
            path=os.path.join(tmpdir, f"resume_{case}.npz")))
    cases += [dict(c, kind="resume") for c in resume]
    spec = {"feds": feds, "cases": cases,
            "params": tree_map(lambda t: t.numpy(), init_mlp_params(0))}
    t0 = time.perf_counter()
    ranks = start_ranks(run_cases, SHARDED_RANKS, backend="gloo",
                        device=str(dev), timeout_s=600, threads=2,
                        args=(spec,))

    # meanwhile the fused twins, one process on the same counter draws, a
    # round an advance for as many rounds as the longest case asks
    fused = {}
    for (case, k, sizes, transmit, mesh, knobs, rounds, step,
         twin) in SHARDED_CASES:
        if twin is None or twin in fused:
            continue
        rounds = max(c[6] for c in SHARDED_CASES if c[8] == twin)
        clients, _ = _federation(dev, data, k, PAPER_SIZES
                                 if sizes == "paper" else FAST_SIZES)
        drv = _paper_driver(dev, clients, transmit,
                            params_mode=knobs.get("params_mode",
                                                  "raveled"))
        globs, secs = [], []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            drv.advance(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            globs.append(drv.global_vec.copy())
        fused[twin] = (globs, drv.history, secs)
        del drv, clients
    got = ranks.wait()
    ranks_s = time.perf_counter() - t0
    # the resumed halves, in fresh ranks
    t0 = time.perf_counter()
    spec["cases"] = [dict(c, kind="restore") for c in resume]
    restored = start_ranks(run_cases, SHARDED_RANKS, backend="gloo",
                           device=str(dev), timeout_s=300, threads=2,
                           args=(spec,)).wait()
    restore_ranks_s = time.perf_counter() - t0
    probe = got[0]["gloo_probe"]
    want = {"SUM": [10.0, 14.0], "MIN": [1.0, 2.0], "MAX": [4.0, 5.0]}
    log({"phase": "sharded_probe", "backend": "gloo", "device": str(dev),
         "ranks": SHARDED_RANKS, "what": "all_reduce of [1 + rank, 5 - "
         "rank] on cuda:0, each op", "got": probe,
         "ok": all(r["gloo_probe"] == want for r in got)})
    if any(r["gloo_probe"] != want for r in got):
        raise AssertionError(f"gloo on CUDA tensors gave {probe}")

    by_path, records = {}, []

    def finish(case, rec, checks):
        rec["checks"] = checks
        log(rec)
        records.append(rec)
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"sharded {case}: failed {failed}")

    for (case, k, sizes, transmit, mesh, knobs, rounds, step,
         twin) in SHARDED_CASES:
        res = [r[case] for r in got]
        r0 = res[0]
        leaves = r0["leaves"]
        same = all(all(np.array_equal(a, b)
                       for a, b in zip(r["globals"], r0["globals"]))
                   for r in res[1:])
        calls = [len(c) for c in r0["calls"]]
        model = [sum(1 for c in cs if c[2] == r0["d"] + 1)
                 for cs in r0["calls"]]
        cross = [sum(1 for c in cs if c[2] == r0["d"] + 1 and "pod" in c[1])
                 for cs in r0["calls"]]
        launches = [r["launches"] for r in res]
        compressed = bool(knobs.get("compress"))
        want_launches = {
            "round_stats": 0 if compressed else leaves * rounds,
            "aircomp_partial": 0 if compressed else leaves * rounds,
            "gather_superpose_partial": rounds if compressed else 0,
            "superpose_normalize": 0, "gather_superpose": 0}
        checks = {
            "ranks_bit_identical": same,
            "finite": bool(np.isfinite(r0["globals"][-1]).all()),
            "some_uploaders": any(row["n_participants"] > 0
                                  for row in r0["rows"]),
            "launches_as_expected_on_every_rank": all(
                la == want_launches for la in launches),
        }
        rec = {"phase": "sharded", "case": case, "clients": k,
               "k_pad": r0["k_pad"], "k_local": r0["k_local"],
               "mesh": mesh, "transmit": transmit, **{
                   kk: vv for kk, vv in knobs.items() if kk != "faults"},
               "rounds": rounds, "step": step, "model_dim": r0["d"],
               "calls_per_step": calls[0], "model_sized_per_step": model,
               "cross_pod_model_sized_per_step": cross,
               "bytes_per_step": sum(c[3] for c in r0["calls"][0]),
               "launches_per_rank": launches,
               "launches_expected_per_rank": want_launches,
               "ms_per_round_4_ranks_on_one_h100_over_gloo": (
                   sum(r0["seconds"][1:]) * 1e3
                   / (rounds - step)),
               "first_step_s": r0["seconds"][0]}
        if knobs.get("cohort_size"):
            m = knobs["cohort_size"]
            rec.update(m_local=r0["m_local"], compress_s=r0["compress_s"],
                       mean_participants=float(np.mean(
                           [row["n_participants"] for row in r0["rows"]])))
            checks["participants_at_most_m"] = all(
                row["n_participants"] <= m for row in r0["rows"])
        if "grouped" in case or case == "blackout":
            n = knobs["group_period"]
            checks["one_cross_pod_all_reduce_a_window"] = all(
                c == step // n for c in cross)
        else:
            checks["one_model_sized_all_reduce_a_round"] = all(
                m == step for m in model)
        if twin is not None:
            globs, hist, secs = fused[twin]
            tol = SHARDED_TOL[transmit]
            gap = max(float(np.abs(a - b).max())
                      for a, b in zip(r0["globals"], globs))
            rec["max_gap_to_fused"] = gap
            rec["varsigma_rel_gap"] = max(
                abs(a["varsigma"] - b["varsigma"]) / max(b["varsigma"],
                                                         1e-30)
                for a, b in zip(r0["rows"], hist))
            # timed while the ranks ran on the same card: contended
            rec["fused_ms_per_round_beside_the_ranks"] = sum(
                secs[1:]) * 1e3 / (len(secs) - 1)
            checks["allclose_to_fused_every_round"] = all(
                np.allclose(a, b, **tol)
                for a, b in zip(r0["globals"], globs))
            checks["participants_equal_fused"] = [
                row["n_participants"] for row in r0["rows"]] == [
                row["n_participants"] for row in hist[:rounds]]
        if case in SHARDED_TWIN_RERUN:
            rec["max_gap_to_twin_rerun"] = max(
                float(np.abs(a - b).max())
                for a, b in zip(r0["globals"], r0["twin_globals"]))
            checks["allclose_to_twin_rerun_every_round"] = all(
                np.allclose(a, b, **SHARDED_TWIN_TOL)
                for a, b in zip(r0["globals"], r0["twin_globals"]))
            checks["participants_equal_twin_rerun"] = [
                row["n_participants"] for row in r0["rows"]] == [
                row["n_participants"] for row in r0["twin_rows"]]
        if case == "grouped_n1":
            flat = got[0]["flat_model"]["globals"]
            checks["bit_equal_to_flat"] = all(
                np.array_equal(a, b) for a, b in zip(r0["globals"], flat))
        if case == "blackout":
            # step 1 ends at round 3, inside [2, 5): pod 1 restarts nobody
            checks["dark_pod_restarts_nobody"] = all(
                r["restarted"][1] == 0 for r in res
                if r["coords"]["pod"] == 1)
            checks["lit_pod_restarts"] = sum(
                sum(r["restarted"]) for r in res
                if r["coords"]["pod"] == 0) > 0
        by_path[f"sharded {case}"] = {
            kk: sum(la[kk] for la in launches) for kk in want_launches}
        finish(case, rec, checks)

    res = [r["state_plane_sharded"] for r in got]
    r0 = res[0]
    checks = {
        "ranks_bit_identical": all(np.array_equal(r["global"], r0["global"])
                                   for r in res[1:]),
        "finite": r0["finite"],
        "some_uploaders": any(n > 0 for n in r0["n_participants"]),
        "participants_at_most_m": all(n <= PLANE_M
                                      for n in r0["n_participants"]),
        "gather_superpose_partial_once_a_round": all(
            r["launches"] == {"round_stats": 0, "aircomp_partial": 0,
                              "superpose_normalize": 0,
                              "gather_superpose": 0,
                              "gather_superpose_partial": PLANE_ROUNDS}
            for r in res),
        "one_model_sized_all_reduce_a_round":
            r0["model_sized"] == PLANE_ROUNDS}
    by_path["sharded state_plane_sharded"] = {
        kk: sum(r["launches"][kk] for r in res)
        for kk in r0["launches"]}
    finish("state_plane_sharded", {
        "phase": "sharded", "case": "state_plane_sharded",
        "clients": PLANE_K, "cohort_size": PLANE_M,
        "m_local": r0["m_local"], "k_local": r0["k_local"],
        "model_dim": PLANE_D, "compress_s": r0["compress_s"],
        "slot_dtype": "int8", "rounds": PLANE_ROUNDS,
        "ms_per_round_4_ranks_on_one_h100_over_gloo": r0["ms_per_round"],
        "calls_per_round": r0["calls_per_round"],
        "mean_participants": float(np.mean(r0["n_participants"])),
        "global_norm": r0["global_norm"],
        "launches_per_rank": [r["launches"] for r in res]}, checks)

    for c in resume:
        full = [r[c["name"]] for r in got]
        back = [r[c["name"]] for r in restored]
        checks = {
            "restored_at_the_kill": all(b["step"] == c["kill"] for b in back),
            "rest_bit_identical": all(
                np.array_equal(b["global"], f["global"])
                and b["history"] == f["history"]
                for f, b in zip(full, back)),
            "ranks_bit_identical": all(
                np.array_equal(b["global"], back[0]["global"])
                for b in back[1:]),
            "some_uploaders_after_the_kill": any(
                row["n_participants"] > 0
                for row in back[0]["history"][c["kill"]:])}
        finish(c["name"], {
            "phase": "sharded_resume", "case": c["name"], "mesh": c["mesh"],
            "rounds": c["rounds"], "kill": c["kill"],
            **{kk: vv for kk, vv in c["knobs"].items() if kk != "faults"},
            "faults": c["knobs"].get("faults"),
            "file_bytes": full[0]["file_bytes"],
            "save_s": max(f["save_s"] for f in full),
            "restore_s": max(b["restore_s"] for b in back),
            "n_screened": sum(row["n_screened"]
                              for row in full[0]["history"])}, checks)
    cli = sharded_cli(dev, tmpdir)
    log({"phase": "sharded_done", "ranks_s": ranks_s,
         "restore_ranks_s": restore_ranks_s, "cli_s": cli["seconds"],
         "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi,
         "device": name, "label": "4 ranks on one H100 over gloo"})
    return by_path, records


CLI_TIMEOUT_S = 300


def sharded_cli(dev, tmpdir):
    """``fl_train --engine sharded`` on SHARDED_RANKS gloo ranks sharing
    ``dev`` (``torch.distributed.run``): the sharded compressed cohort at
    K = 1000 (m = 64, top-k int8) for 10 rounds with a checkpoint every 5,
    then a fresh run resumed from round 5's file for the last 5; rank 0's
    last CSV rows must match (every column but the wall clock)."""
    from repro_torch.launch.mesh import free_init_method
    ckdir = os.path.join(tmpdir, "cli_checkpoints")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2",
               REPRO_BENCH_OUT=os.path.join(tmpdir, "cli_bench"))

    def run(tag, extra):
        port = free_init_method().rsplit(":", 1)[1]
        out = os.path.join(tmpdir, f"cli_{tag}.csv")
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc-per-node", str(SHARDED_RANKS), "--master-port", port,
               "-m", "repro_torch.launch.fl_train", "--engine", "sharded",
               "--dist-backend", "gloo", "--device", str(dev), "--clients",
               str(COHORT_K), "--cohort-size", str(COHORT_M), "--compress",
               "topk", "--slot-dtype", "int8", "--out", out, *extra]
        logpath = os.path.join(tmpdir, f"cli_{tag}.log")
        t1 = time.perf_counter()
        # its own session, so a timeout kills the launcher's ranks too
        with open(logpath, "w") as logf:
            proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                                    stdout=logf, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                rc = proc.wait(timeout=CLI_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                rc = f"killed after {CLI_TIMEOUT_S} s"
        if rc != 0:
            with open(logpath) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"fl_train --engine sharded ({tag}): exit "
                               f"{rc}:\n{tail}")
        with open(out, newline="") as f:
            rows = list(csv.DictReader(f))
        return rows, time.perf_counter() - t1

    full, full_s = run("full", ["--checkpoint-every", "5", "--rounds", "10",
                                "--checkpoint-dir", ckdir])
    res, res_s = run("resumed", ["--resume",
                                 os.path.join(ckdir, "round_000005.npz"),
                                 "--rounds", "5"])

    def strip(row):
        return {k: v for k, v in row.items() if k != "wall_s"}
    rec = {"phase": "sharded_cli", "clients": COHORT_K,
           "cohort_size": COHORT_M, "compress": "topk",
           "slot_dtype": "int8", "checkpoints": sorted(os.listdir(ckdir)),
           "full_s": full_s, "resumed_s": res_s,
           "seconds": full_s + res_s, "last_row": strip(full[-1]),
           "checks": {"last_rows_match": strip(full[-1]) == strip(res[-1]),
                      "resumed_from_round_5": strip(res[0])["round"] == "5",
                      "two_files": len(os.listdir(ckdir)) == 2}}
    log(rec)
    failed = [c for c, ok in rec["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"sharded_cli: failed {failed}")
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

    # 5b. the sharded round: 4 ranks over gloo on this card, each case
    # against the fused round; the partial entry against its twin
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
        sharded_paths, sharded_recs = sharded(dev, data, tmpdir, name, smi)
    by_path.update(sharded_paths)
    for kname in ("aircomp_partial", "gather_superpose_partial"):
        launches[kname] = sum(v[kname] for v in sharded_paths.values())
    partial = partial_times(dev, bw, flops)

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
    plane = next(r for r in sharded_recs
                 if r["case"] == "state_plane_sharded")
    log({"phase": "state_plane_sharded_vs_single", "slot_dtype": "int8",
         "clients": PLANE_K, "cohort_size": PLANE_M, "model_dim": PLANE_D,
         "single_device_ms_per_round": rec["ms_per_round"],
         "sharded_ms_per_round_4_ranks_on_one_h100_over_gloo":
             plane["ms_per_round_4_ranks_on_one_h100_over_gloo"]})

    # 12-15. the LM slice: both kernels against their twins, the SWA
    # kernel's own entry point, mamba2-370m serving at full width
    ssd_parity(dev, main_err)
    swa = swa_path(swa_parity(dev, main_err))
    by_path["swa_path"] = swa["launches"]
    launches["swa_attention"] = swa["launches"]["swa_attention"]
    swa_bwd = swa_bwd_parity(dev, bw, flops, tf32)
    ssd_bwd = ssd_bwd_parity(dev, bw, flops, tf32)
    lm = lm_serve(dev)
    by_path["lm_serve prefill"] = lm["launches"]["prefill_all"]
    by_path["lm_serve decode"] = lm["launches"]["decode_all"]
    launches["ssd_chunk"] = lm["launches"]["prefill"]
    del lm

    # 15b. zamba2-7b serving: both LM kernels on one model's path
    hy = hybrid_serve(dev, bw, flops, tf32)
    by_path["hybrid_serve prefill"] = hy["launches"]["prefill"]
    by_path["hybrid_serve decode"] = hy["launches"]["decode"]
    for kname in ("ssd_chunk", "swa_attention"):
        launches[kname] += hy["launches"]["prefill"][kname]
    torch.cuda.empty_cache()

    # 15c. the dense family's serving at full width, and the serve CLI
    dense = dense_serve(dev, bw, flops, tf32)
    for arch, rec in dense["runs"].items():
        by_path[f"dense_serve {arch} prefill"] = rec["launches"]["prefill"]
        by_path[f"dense_serve {arch} decode"] = rec["launches"]["decode"]
        launches["swa_attention"] += rec["launches"]["prefill"][
            "swa_attention"]
    by_path["dense_serve cli"] = dense["cli"]["launches"]
    torch.cuda.empty_cache()

    # 15d. the moe family's serving: mixtral-8x22b at full width, 4 layers
    moe = moe_serve(dev, bw, flops, tf32)
    llama4 = moe["llama4"]
    by_path["moe_serve prefill"] = moe["launches"]["prefill"]
    by_path["moe_serve decode"] = moe["launches"]["decode"]
    by_path["moe_serve llama4 prefill"] = llama4["launches"]["prefill"]
    by_path["moe_serve llama4 decode"] = llama4["launches"]["decode"]
    for rec in (moe, llama4):
        launches["swa_attention"] += rec["launches"]["prefill"][
            "swa_attention"]
    torch.cuda.empty_cache()

    # 15e-15f. internvl2-1b's [patches; text] serving and hubert-xlarge's
    # bidirectional encoder, both at full width
    vlm = vlm_serve(dev, bw, flops, tf32)
    by_path["vlm_serve prefill"] = vlm["launches"]["prefill"]
    by_path["vlm_serve decode"] = vlm["launches"]["decode"]
    launches["swa_attention"] += vlm["launches"]["prefill"]["swa_attention"]
    torch.cuda.empty_cache()
    audio = audio_encode(dev, bw, flops, tf32)
    by_path["audio_encode forward"] = audio["launches"]["forward"]
    launches["swa_attention"] += audio["launches"]["forward"][
        "swa_attention"]
    torch.cuda.empty_cache()

    # 15g. smollm-135m's PAOTA training at full width: the attention
    # kernel's forward and backward in every layer, sweep 2 per leaf
    train = lm_train(dev, bw, flops, tf32)
    launches["swa_attention_bwd"] = 0
    for rec in train["rounds"]:
        by_path[f"lm_train round {rec['round']}"] = rec["launches"]
        for kname in ("swa_attention", "swa_attention_bwd",
                      "superpose_normalize"):
            launches[kname] += rec["launches"][kname]
    torch.cuda.empty_cache()

    # 15h. mamba2-370m's PAOTA training at full width and zamba2-7b's at
    # full width, cut depth: the SSD kernel's forward and backward in
    # every layer (zamba2: the attention pair at each shared slot)
    launches["ssd_chunk_bwd"] = 0
    for tag, rec in (("ssm_train", ssm_train(dev, bw, flops, tf32)),
                     ("hybrid_train", hybrid_train(dev, bw, flops, tf32))):
        for rnd in rec["rounds"]:
            by_path[f"{tag} round {rnd['round']}"] = rnd["launches"]
            for kname in ("ssd_chunk", "ssd_chunk_bwd", "swa_attention",
                          "swa_attention_bwd", "superpose_normalize"):
                launches[kname] += rnd["launches"][kname]
        torch.cuda.empty_cache()

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
    # last, so that the profiler cannot slow a phase after it
    train_profile(dev)

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
        if kname == "superpose_normalize":
            kernels[-1]["train_leaf_shapes"] = train["sweep2_by_leaf"]
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
        kernels[-1]["in_model"] = dict(
            {k: hy["in_model_kernels"][kname][k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")},
            arch="zamba2-7b", launches_per_prefill=hy["launches"][
                "prefill"][kname])
        if kname == "swa_attention":
            kernels[-1]["in_model_by_arch"] = {
                arch: dict({k: rec["in_model_swa_attention"][k] for k in (
                    "shape", "kv_heads", "dtype", "causal", "max_abs_err",
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")},
                    launches_per_prefill=rec["launches"]["prefill"][kname])
                for arch, rec in dict(dense["runs"], **{
                    MOE_ARCH: moe, L4_ARCH: llama4, VLM_ARCH: vlm,
                    AUDIO_ARCH: audio}).items()}
            for arch, rec in ((MOE_ARCH, moe), (L4_ARCH, llama4)):
                kernels[-1]["in_model_by_arch"][arch].update(
                    {k: rec["in_model_swa_attention"][k] for k in (
                        "window", "checked_rows", "plain_ms_checked_rows")},
                    layers=rec["layers"])
            kernels[-1]["long_row_by_arch"] = {AUDIO_ARCH: {
                k: audio["long_row_swa_attention"][k] for k in (
                    "shape", "causal", "max_abs_err", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by",
                    "bound_at_padded_d_ms")}}
        if "reference_shape" in t:
            ref = t["reference_shape"]
            kernels[-1]["reference_shape"] = {
                "shape": list(SSD_MAIN), "max_abs_err": main_err.get(
                    "ssd_chunk_reference_shape"),
                **{k: ref[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "yardstick_ms")}}
    kernels.append({
        "name": "aircomp_partial", "route": "cuda",
        "source": "src/repro_torch/csrc/aircomp_sum.cu",
        "replaces": "src/repro/kernels/aircomp_sum.py:237 "
                    "(aircomp_partial_tree, plain dot_general; no Pallas "
                    "kernel)",
        "launches": launches["aircomp_partial"],
        "launches_by_path": {p: v["aircomp_partial"]
                             for p, v in by_path.items()
                             if "aircomp_partial" in v},
        **{key: partial["aircomp_partial"][0][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library", "shape", "dtype")},
        "other_shapes": [{key: o[key] for key in (
            "shape", "seg", "pitch", "dtype", "max_abs_err", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for o in partial["aircomp_partial"][1:]]})
    gsp = partial["gather_superpose_partial"]
    kernels.append({
        "name": "gather_superpose_partial", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_superpose.cu",
        "replaces": "src/repro/kernels/aircomp_sum.py:438 "
                    "(gather_superpose_psum, plain jnp; no Pallas kernel)",
        "launches": launches["gather_superpose_partial"],
        "launches_by_path": {p: v["gather_superpose_partial"]
                             for p, v in by_path.items()
                             if "gather_superpose_partial" in v},
        "max_abs_err": gsp[0]["max_abs_err_over_varsigma"],
        "max_abs_err_of": "the sums divided by sum bp",
        **{key: gsp[0][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "yardstick_ms", "yardstick", "shape", "dtype")},
        "other_shapes": [{key: o[key] for key in (
            "shape", "dtype", "max_abs_err_over_varsigma", "ms", "plain_ms",
            "yardstick_ms", "library_ms", "bound_ms", "bound_by")}
            for o in gsp[1:]]})
    main_bwd, other_bwd = swa_bwd[0], swa_bwd[1:]
    kernels.append({
        "name": "swa_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/swa_attention.cu",
        "replaces": "src/repro/models/layers.py:213 (_flash_bwd, the "
                    "reference's custom VJP; no Pallas kernel)",
        "launches": launches["swa_attention_bwd"],
        "launches_by_path": {p: v["swa_attention_bwd"]
                             for p, v in by_path.items()
                             if "swa_attention_bwd" in v},
        "max_abs_err": main_bwd["float32"]["max_abs_err"],
        "max_abs_err_bf16": main_bwd["bfloat16"]["max_abs_err"],
        **{f"{key}_bf16": main_bwd["bfloat16"][key] for key in (
            "ms", "library_ms", "bound_ms", "bound_by")},
        **{key: main_bwd[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library", "bound_cuda_cores_ms", "bound_as_run_ms",
            "forward_ms", "shape", "model", "kv_heads", "causal")},
        "dtype": "float32",
        "other_shapes": [{key: o[key] for key in (
            "model", "shape", "kv_heads", "window", "causal", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_cuda_cores_ms", "bound_as_run_ms")} | {
                "max_abs_err": o["float32"]["max_abs_err"],
                "max_abs_err_bf16": o["bfloat16"]["max_abs_err"]} | {
                f"{key}_bf16": o["bfloat16"][key] for key in (
                    "ms", "library_ms", "bound_ms", "bound_by")}
            for o in other_bwd]})
    main_ssd, other_ssd = ssd_bwd[0], ssd_bwd[1:]
    kernels.append({
        "name": "ssd_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk_bwd.cu",
        "replaces": "src/repro/models/ssm.py:81 (ssd_chunked's plain jnp, "
                    "which jax.grad differentiates; no Pallas kernel)",
        "launches": launches["ssd_chunk_bwd"],
        "launches_by_path": {p: v["ssd_chunk_bwd"]
                             for p, v in by_path.items()
                             if "ssd_chunk_bwd" in v},
        "max_abs_err": main_ssd["float32"]["max_abs_err"],
        "max_abs_err_bf16": main_ssd["bfloat16"]["max_abs_err"],
        **{f"{key}_bf16": main_ssd["bfloat16"][key] for key in (
            "ms", "library_ms", "bound_ms", "bound_by")},
        **{key: main_ssd[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library", "bound_cuda_cores_ms", "bound_as_run_ms",
            "forward_ms", "shape", "model", "kv_heads", "causal")},
        "yardstick_ms": main_ssd["yardstick_ms"],
        "yardstick": main_ssd["yardstick"],
        "dtype": "float32",
        "other_shapes": [{key: o[key] for key in (
            "model", "shape", "kv_heads", "causal", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_cuda_cores_ms",
            "bound_as_run_ms")} | {
                "max_abs_err": o["float32"]["max_abs_err"],
                "max_abs_err_bf16": o["bfloat16"]["max_abs_err"]} | {
                f"{key}_bf16": o["bfloat16"][key] for key in (
                    "ms", "library_ms", "bound_ms", "bound_by")}
            for o in other_ssd]})
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
