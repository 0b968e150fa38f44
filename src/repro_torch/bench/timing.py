"""The one timing method of the port's benches and ``chip_smoke.py``.

On the card a call is timed with CUDA events around it, after the L2
cache was flushed by zeroing a 256 MB buffer (the round finds its planes
cold after local SGD), and the median of ``TIMING_RUNS`` calls is kept
(``time_ms``); ``graph_ms`` replays the call from a CUDA graph, which
leaves the device's time without the host's time to issue it. On the
CPU, ``call_us`` and ``median_s`` read the wall clock instead.
"""
from __future__ import annotations

import statistics
import time

import torch

TIMING_RUNS = 60
FLUSH_BYTES = 256 * 2**20


def l2_flush(device) -> torch.Tensor:
    """The buffer whose ``zero_()`` before each timed call evicts the
    card's L2 (50 MB on an H100)."""
    return torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)


def sync(device) -> None:
    """Wait for the card's queued work; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, flush, runs: int = TIMING_RUNS) -> float:
    """Median ms of one call, CUDA events around it, the L2 cache flushed
    before every call."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn, flush, runs: int = TIMING_RUNS) -> float:
    """``time_ms`` of ``fn`` captured once in a CUDA graph and replayed:
    the device's time for its launches, without the host's time to issue
    them."""
    fn()                                    # warm the plans and the pool
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, flush, runs)


def median_s(fn, reps: int, device) -> float:
    """Median wall seconds of ``reps`` calls, each ending in a
    synchronize: robust to background-load spikes on the host."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def call_us(fn, device, runs: int = 20) -> float:
    """µs per call of ``fn`` on ``device``: ``time_ms`` (CUDA events,
    flushed L2) on the card, the wall-clock median after one warm-up call
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return time_ms(fn, l2_flush(dev), runs) * 1e3
    fn()
    return median_s(fn, runs, dev) * 1e6
