"""Fused round statistics (sweep 1 of the round): CUDA kernel + plain twin.

Replaces the TPU kernel ``repro/kernels/round_stats.py::round_stats_pallas``
(Pallas bodies ``_kernel`` and ``_kernel_payload``). One pass over the
(K, D) delta plane, and over the payload plane when one is given:

    stats[k] = [sum_d delta*g, sum_d delta^2 (, sum_d payload^2)]
    gn2      = sum_d g^2

Bound on the H100: memory bytes (K*D*s read, twice that with a payload,
2-3 FMAs per element). The kernel (``csrc/round_stats.cu``) gives each
row one block that reduces in a fixed order, so it needs no atomics and is
identical from run to run; it masks the ragged row edge instead of padding
D to a tile multiple (D = 8070 rows are not 16-byte aligned).

``round_stats_cuda`` launches the kernel and counts its launches in the
module-level ``launches``; ``round_stats_plain`` is the plain-torch twin the
CPU path runs and the card holds the kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_FLOATS = (torch.float32, torch.bfloat16)


def check_inputs(deltas, g, payload=None) -> None:
    """Raise on anything the kernel does not take: (K, D) f32/bf16 deltas,
    a (D,) f32 direction, an optional payload matching the deltas, all
    contiguous and on one device."""
    if deltas.dim() != 2 or deltas.shape[0] < 1 or deltas.shape[1] < 1:
        raise ValueError(f"deltas must be a non-empty (K, D) matrix, got "
                         f"shape {tuple(deltas.shape)}")
    if deltas.dtype not in _FLOATS:
        raise TypeError(f"deltas dtype {deltas.dtype}: expected float32 or "
                        f"bfloat16")
    if g.dtype != torch.float32:
        raise TypeError(f"g dtype {g.dtype}: expected float32")
    if tuple(g.shape) != (deltas.shape[1],):
        raise ValueError(f"g shape {tuple(g.shape)} != (D,) = "
                         f"({deltas.shape[1]},)")
    tensors = [deltas, g]
    if payload is not None:
        if payload.shape != deltas.shape or payload.dtype != deltas.dtype:
            raise ValueError(f"payload {tuple(payload.shape)} "
                             f"{payload.dtype} must match deltas "
                             f"{tuple(deltas.shape)} {deltas.dtype}")
        tensors.append(payload)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("round_stats inputs must be contiguous")
        if t.device != deltas.device:
            raise ValueError(f"round_stats inputs span devices "
                             f"{t.device} and {deltas.device}")


def round_stats_plain(deltas, g, payload=None):
    """Plain-torch twin: ``(stats (K, 2|3) f32, gn2 f32 scalar)``."""
    check_inputs(deltas, g, payload)
    d32 = deltas.float()
    cols = [d32 @ g, (d32 * d32).sum(1)]
    if payload is not None:
        p32 = payload.float()
        cols.append((p32 * p32).sum(1))
    return torch.stack(cols, dim=1), (g * g).sum()


def _lib():
    fn = build.library("round_stats").repro_round_stats
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def round_stats_cuda(deltas, g, payload=None):
    """Launch the CUDA kernel: ``(stats (K, 2|3) f32, gn2 f32 scalar)``.
    Raises on a tensor off the GPU or a failed launch; never falls back."""
    global launches
    check_inputs(deltas, g, payload)
    if deltas.device.type != "cuda":
        raise ValueError(f"round_stats_cuda needs CUDA tensors, got "
                         f"{deltas.device}")
    k, d = deltas.shape
    if k > 2**31 - 1:
        raise ValueError(f"K={k} exceeds the kernel's grid")
    fn = _lib()
    ncol = 2 if payload is None else 3
    stats = torch.empty((k, ncol), dtype=torch.float32, device=deltas.device)
    gn2 = torch.empty((), dtype=torch.float32, device=deltas.device)
    with torch.cuda.device(deltas.device):
        stream = torch.cuda.current_stream(deltas.device).cuda_stream
        rc = fn(deltas.data_ptr(),
                None if payload is None else payload.data_ptr(),
                g.data_ptr(), stats.data_ptr(), gn2.data_ptr(), k, d,
                int(deltas.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"round_stats kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return stats, gn2
