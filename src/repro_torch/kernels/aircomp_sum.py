"""Fused superpose-and-normalize (sweep 2 of the round): CUDA kernel + plain
twin.

Replaces the TPU kernel
``repro/kernels/aircomp_sum.py::superpose_normalize_pallas`` (Pallas body
``_superpose_kernel``). With bp = powers * mask, eqs. (6)+(8) in one pass
over the (K, D) payload plane:

    agg      = (sum_k bp_k x_k + noise) / max(sum_k bp_k, vs_min)
    varsigma = sum_k bp_k                               (raw, unclamped)

Bound on the H100: memory bytes (K*D*s read once, one FMA each). The
kernel (``csrc/aircomp_sum.cu``) gives each block 32 columns and splits the
K rows over its 8 warps, adding the partials in a fixed order; every block
sums bp in the same order and block 0 writes it. No atomics, so the result
is identical from run to run, as the scanned reference round's is.

``superpose_normalize_cuda`` launches the kernel and counts its launches in
the module-level ``launches``; ``superpose_normalize_plain`` is the
plain-torch twin the CPU path runs and the card holds the kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_FLOATS = (torch.float32, torch.bfloat16)


def check_inputs(stacked, powers, mask, noise) -> None:
    """Raise on anything the kernel does not take: a (K, D) f32/bf16
    payload, (K,) f32 powers and mask, a (D,) f32 noise vector, all
    contiguous and on one device."""
    if stacked.dim() != 2 or stacked.shape[0] < 1 or stacked.shape[1] < 1:
        raise ValueError(f"stacked must be a non-empty (K, D) matrix, got "
                         f"shape {tuple(stacked.shape)}")
    if stacked.dtype not in _FLOATS:
        raise TypeError(f"stacked dtype {stacked.dtype}: expected float32 "
                        f"or bfloat16")
    k, d = stacked.shape
    for name, t, shape in (("powers", powers, (k,)), ("mask", mask, (k,)),
                           ("noise", noise, (d,))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    for t in (stacked, powers, mask, noise):
        if not t.is_contiguous():
            raise ValueError("superpose_normalize inputs must be contiguous")
        if t.device != stacked.device:
            raise ValueError(f"superpose_normalize inputs span devices "
                             f"{t.device} and {stacked.device}")


def superpose_normalize_plain(stacked, powers, mask, noise,
                              vs_min: float = 1e-12):
    """Plain-torch twin: ``(agg (D,) f32, raw varsigma f32 scalar)``."""
    check_inputs(stacked, powers, mask, noise)
    bp = powers * mask
    raw = bp.sum()
    acc = bp @ stacked.float()
    return (acc + noise) / torch.clamp_min(raw, vs_min), raw


def _lib():
    fn = build.library("aircomp_sum").repro_superpose_normalize
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def superpose_normalize_cuda(stacked, powers, mask, noise,
                             vs_min: float = 1e-12):
    """Launch the CUDA kernel: ``(agg (D,) f32, raw varsigma f32 scalar)``.
    Raises on a tensor off the GPU or a failed launch; never falls back."""
    global launches
    check_inputs(stacked, powers, mask, noise)
    if stacked.device.type != "cuda":
        raise ValueError(f"superpose_normalize_cuda needs CUDA tensors, got "
                         f"{stacked.device}")
    k, d = stacked.shape
    if (d + 31) // 32 > 2**31 - 1:
        raise ValueError(f"D={d} exceeds the kernel's grid")
    fn = _lib()
    agg = torch.empty((d,), dtype=torch.float32, device=stacked.device)
    raw = torch.empty((), dtype=torch.float32, device=stacked.device)
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        rc = fn(stacked.data_ptr(), powers.data_ptr(), mask.data_ptr(),
                noise.data_ptr(), agg.data_ptr(), raw.data_ptr(), k, d,
                float(vs_min), int(stacked.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"superpose_normalize kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return agg, raw
