"""Kernel micro-benchmarks at the reference's shapes: the four delta-plane
kernels at K x d = 100 x 8070 (the paper's clients and MLP) and the
sliding-window attention at (4, 512, 64) with window 128.

The port's ``benchmarks/kernels_bench.py``, with the reference's five rows
by the same names and derived columns. Each ``_ref_`` row times the
plain-torch twin (the port's counterpart of the reference's jnp path);
on the card a row without ``_ref`` beside it times the hand-written
kernel on the same inputs with the same helper (``timing.call_us``: CUDA
events and a flushed L2 on the card, the wall clock on the CPU). On the
CPU only the twin rows run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.timing import call_us
from repro_torch.device import resolve_device
from repro_torch.kernels import aircomp_sum as ac
from repro_torch.kernels import cosine_sim as cs
from repro_torch.kernels import round_stats as rs
from repro_torch.kernels import swa_attention as swa

K, D = 100, 8070
SWA_SHAPE, SWA_WINDOW = (4, 512, 64), 128


def cases(device) -> list:
    """(twin row name, kernel row name, twin, kernel, args, derived) per
    kernel: the inputs are made with numpy from one seed, as the
    reference's are, and moved to ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    k, d = K, D
    x = t(rng.normal(size=(k, d)))
    bp = t(rng.random(k))
    noise = t(rng.normal(size=d))
    g = t(rng.normal(size=d))
    mask = t((rng.random(k) < 0.5).astype(np.float32))
    q = t(rng.normal(size=SWA_SHAPE))
    tag = f"K{k}_d{d}"
    win_flops = 2 * 2 * 4 * 512 * (128 + 64) * 64
    full_flops = 2 * 2 * 4 * 512 * 512 * 64

    def swa_fn(fn):
        return lambda q_: fn(q_, q_, q_, window=SWA_WINDOW)

    return [
        (f"aircomp_sum_ref_{tag}", f"aircomp_sum_{tag}",
         ac.aircomp_sum_plain, ac.aircomp_sum_cuda, (x, bp, noise),
         f"bytes={(k * d + 2 * d) * 4};fused_passes=1_vs_4_naive"),
        (f"cosine_partials_ref_{tag}", f"cosine_partials_{tag}",
         cs.cosine_partials_plain, cs.cosine_partials_cuda, (x, g),
         f"bytes={(k * d + d) * 4};one_pass=True"),
        # sweep 1 with the deltas as their own payload, as the reference's
        # row times it
        (f"round_stats_ref_{tag}", f"round_stats_{tag}",
         lambda x_, g_: rs.round_stats_plain(x_, g_, x_),
         lambda x_, g_: rs.round_stats_cuda(x_, g_, x_), (x, g),
         f"bytes={(2 * k * d + d) * 4};fused_passes=1_vs_3_naive"),
        (f"superpose_normalize_ref_{tag}", f"superpose_normalize_{tag}",
         ac.superpose_normalize_plain, ac.superpose_normalize_cuda,
         (x, bp, mask, noise),
         f"bytes={(k * d + 2 * d) * 4};fused_passes=1_vs_4_naive;"
         f"emits_varsigma=True"),
        ("swa_ref_T512_w128", "swa_T512_w128",
         swa_fn(swa.swa_attention_plain), swa_fn(swa.swa_attention_cuda),
         (q,), f"window_flops_saving={1 - win_flops / full_flops:.0%}"),
    ]


def run(device=None) -> list:
    dev = resolve_device(device)
    rows = []
    for ref_name, name, twin, kernel, args, derived in cases(dev):
        rows.append({"name": ref_name,
                     "us_per_call": round(call_us(lambda: twin(*args), dev),
                                          1),
                     "derived": derived})
        if dev.type == "cuda":
            rows.append({"name": name,
                         "us_per_call": round(
                             call_us(lambda: kernel(*args), dev), 1),
                         "derived": derived})
    return rows


if __name__ == "__main__":
    for row in run():
        print(f"{row['name']},{row['us_per_call']},{row['derived']}")
