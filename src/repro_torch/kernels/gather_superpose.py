"""AirComp over the compressed (m, s) cohort plane: CUDA kernel + plain twin.

Replaces the TPU kernel
``repro/kernels/aircomp_sum.py::gather_superpose_pallas`` (Pallas body
``_gather_superpose_kernel``). Each slot's stored values on its own
support superpose straight into d-space, so decompression IS the
superposition and the dense (m, d) plane never exists:

    agg = (noise + sum_k w_k scatter(v_k, idx_k)) / max(sum_k bp_k, vs_min)
    raw = sum_k bp_k                                     (unclamped)

with w_k = bp_k, or bp_k * scale_k for int8 values (the dequantization
factor folds into the weight; varsigma stays the raw sum of bp).

Bound on the H100: memory bytes, m*s*(sizeof(v) + 4) + 8m + 8d. The
kernel (``csrc/gather_superpose.cu``) runs a grid of column stripes (up
to 1024 wide) by row splits (``plan``). Each of a block's sixteen warps
takes every sixteenth row of its split, stages the row's indices into its
own shared-memory ring with cp.async, several segments in flight, and adds
w_k * v into a warp-private stripe accumulator; a row's indices are
distinct, so no lanes collide. The block sums the warps' partials in a
fixed order; with row splits the last block of a stripe to arrive adds
noise and the splits' partials in split order. No float atomics, so
repeated calls are bit-identical. It masks the ragged stripe and pads
nothing (the Pallas wrapper pads m*s to 1024 and d to 512).

``gather_superpose_cuda`` launches the kernel and counts its launches in
the module-level ``launches``; ``gather_superpose_plain`` is the
plain-torch twin the CPU path runs (the reference's CPU twin: a transient
dense scatter, the f32 contraction with w, then the noise) and the card
holds the kernel against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_inputs(values, idx, bp, noise, d: int, scale=None) -> None:
    """Raise on anything the kernel does not take: (m, s) f32/bf16/int8
    values, (m, s) int32 indices, (m,) f32 bp and scale, a (d,) f32 noise
    vector, all contiguous and on one device."""
    if values.dim() != 2 or values.shape[0] < 1 or values.shape[1] < 1:
        raise ValueError(f"values must be a non-empty (m, s) matrix, got "
                         f"shape {tuple(values.shape)}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"values dtype {values.dtype}: expected float32, "
                        f"bfloat16 or int8")
    if d < 1:
        raise ValueError(f"d={d}: expected d >= 1")
    m, s = values.shape
    if idx.dtype != torch.int32:
        raise TypeError(f"idx dtype {idx.dtype}: expected int32")
    if tuple(idx.shape) != (m, s):
        raise ValueError(f"idx shape {tuple(idx.shape)} != {(m, s)}")
    named = [("bp", bp, (m,)), ("noise", noise, (d,))]
    if scale is not None:
        named.append(("scale", scale, (m,)))
    for name, t, shape in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    for t in [values, idx] + [t for _, t, _ in named]:
        if not t.is_contiguous():
            raise ValueError("gather_superpose inputs must be contiguous")
        if t.device != values.device:
            raise ValueError(f"gather_superpose inputs span devices "
                             f"{t.device} and {values.device}")


def gather_superpose_plain(values, idx, bp, noise, *, d: int, scale=None,
                           vs_min: float = 1e-12):
    """Plain-torch twin: ``(agg (d,) f32, raw varsigma f32 scalar)``."""
    check_inputs(values, idx, bp, noise, d, scale)
    w = bp if scale is None else bp * scale
    raw = bp.sum()
    dense = torch.zeros((values.shape[0], d), dtype=torch.float32,
                        device=values.device)
    dense.scatter_add_(1, idx.long(), values.float())
    acc = w @ dense
    return (acc + noise) / torch.clamp_min(raw, vs_min), raw


STRIPE, MAX_STRIPE, WARPS = 64, 1024, 16   # csrc/gather_superpose.cu's


def plan(m: int, d: int, sms: int) -> tuple[int, int]:
    """(columns per block, row splits): the widest stripe the kernel takes,
    then as many row splits as fill one wave of ``sms`` blocks while each
    split keeps at least one row per warp."""
    stripe = min(MAX_STRIPE, -(-d // STRIPE) * STRIPE)
    stripes = -(-d // stripe)
    splits = max(1, min(sms // stripes, m // WARPS))
    return stripe, splits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("gather_superpose").repro_gather_superpose
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_superpose_cuda(values, idx, bp, noise, *, d: int, scale=None,
                          vs_min: float = 1e-12):
    """Launch the CUDA kernel: ``(agg (d,) f32, raw varsigma f32 scalar)``.
    Raises on a tensor off the GPU or a failed launch; never falls back."""
    global launches
    check_inputs(values, idx, bp, noise, d, scale)
    if values.device.type != "cuda":
        raise ValueError(f"gather_superpose_cuda needs CUDA tensors, got "
                         f"{values.device}")
    m, s = values.shape
    dev = values.device
    stripe, splits = plan(m, d, _sm_count(dev.index))
    if -(-d // stripe) > 2**31 - 1:
        raise ValueError(f"d={d} exceeds the kernel's grid")
    fn = _lib()
    agg = torch.empty((d,), dtype=torch.float32, device=dev)
    raw = torch.empty((), dtype=torch.float32, device=dev)
    partial = arrived = None
    if splits > 1:
        partial = torch.empty((splits, d), dtype=torch.float32, device=dev)
        arrived = torch.empty((-(-d // stripe),), dtype=torch.int32,
                              device=dev)     # zeroed by the launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(values.data_ptr(), idx.data_ptr(), bp.data_ptr(),
                None if scale is None else scale.data_ptr(),
                noise.data_ptr(), agg.data_ptr(), raw.data_ptr(),
                None if partial is None else partial.data_ptr(),
                None if arrived is None else arrived.data_ptr(), m, s, d,
                stripe, splits, float(vs_min), _DTYPES[values.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gather_superpose kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return agg, raw
