"""Per-client cosine partials: CUDA kernel + plain twin.

Replaces the TPU kernel ``repro/kernels/cosine_sim.py::cosine_partials_pallas``
(Pallas body ``_kernel``). One pass over the (K, D) delta plane:

    out[k] = [sum_d delta[k, d] * g[d], sum_d delta[k, d]^2]      (K, 2) f32

``repro_torch.kernels.ops.cosine_sim`` finishes the cosine. Bound on the
H100: memory bytes, 4 (K D + D + 2 K) in f32, two FMAs per element. The
kernel is the sweep-1 body (``csrc/round_stats.cu``, entry
``repro_cosine_partials``) without a payload and without ||g||^2, on
sweep 1's plan (``round_stats.plan``): a block per row with every load of
a pass in flight, as wide as the pitch allows; the sums run in a fixed
order with no float atomics, so repeated calls are bit-identical; the
ragged D edge is masked in the kernel, where the Pallas wrapper pads D to
512 with a copy.

``cosine_partials_cuda`` launches the kernel and counts its launches in the
module-level ``launches``; ``cosine_partials_plain`` is the plain-torch
twin the CPU path runs and the card holds the kernel against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.round_stats import check_inputs, device_plan

launches = 0


def cosine_partials_plain(deltas, g):
    """Plain-torch twin: (K, 2) f32 [dot_k, ||delta_k||^2]."""
    check_inputs(deltas, g)
    d32 = deltas.float()
    return torch.stack([d32 @ g, (d32 * d32).sum(1)], dim=1)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("round_stats").repro_cosine_partials
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def cosine_partials_cuda(deltas, g):
    """Launch the CUDA kernel: (K, 2) f32. Raises on a tensor off the GPU
    or a failed launch; never falls back."""
    global launches
    check_inputs(deltas, g)
    if deltas.device.type != "cuda":
        raise ValueError(f"cosine_partials_cuda needs CUDA tensors, got "
                         f"{deltas.device}")
    k, d = deltas.shape
    if k > 2**31 - 1:
        raise ValueError(f"K={k} exceeds the kernel's grid")
    vec, threads = device_plan(deltas, g)
    dev = deltas.device
    out = torch.empty((k, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(deltas.data_ptr(), g.data_ptr(), out.data_ptr(), k, d,
                    int(deltas.dtype == torch.bfloat16), stream, vec,
                    threads)
    if rc != 0:
        raise RuntimeError(f"cosine_partials kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
