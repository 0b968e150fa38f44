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

``gather_superpose_partial`` is the local half of the sharded round's
compressed superposition, which the reference computes as plain jnp
(``repro/kernels/aircomp_sum.py::gather_superpose_psum``; it replaces no
Pallas kernel): the same body with no noise and no division,

    out[offset + c] = sum_k w_k scatter(v_k, idx_k)[c],  out[-1] = sum_k bp_k

into the flat (d + 1,) f32 buffer one all-reduce sends. Same bound (4d
bytes written in place of 8d). ``gather_superpose_partial_cuda`` counts
its launches in ``partial_launches``; ``gather_superpose_partial_plain``
(a dense scatter_add, ``w @ dense``, then the sum of bp) is its twin.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0              # gather_superpose_cuda launches
partial_launches = 0      # gather_superpose_partial_cuda launches

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_inputs(values, idx, bp, noise, d: int, scale=None) -> None:
    """Raise on anything the kernel does not take: (m, s) f32/bf16/int8
    values, (m, s) int32 indices, (m,) f32 bp and scale, a (d,) f32 noise
    vector (None: the partial entry's, which takes none), all contiguous
    and on one device."""
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
    named = [("bp", bp, (m,))]
    if noise is not None:
        named.append(("noise", noise, (d,)))
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


def _superposed(values, idx, bp, d: int, scale):
    """The twins' sum: (sum_k w_k scatter(v_k, idx_k) (d,) f32, raw sum of
    bp), through a transient dense (m, d) scatter."""
    w = bp if scale is None else bp * scale
    dense = torch.zeros((values.shape[0], d), dtype=torch.float32,
                        device=values.device)
    dense.scatter_add_(1, idx.long(), values.float())
    return w @ dense, bp.sum()


def gather_superpose_plain(values, idx, bp, noise, *, d: int, scale=None,
                           vs_min: float = 1e-12):
    """Plain-torch twin: ``(agg (d,) f32, raw varsigma f32 scalar)``."""
    check_inputs(values, idx, bp, noise, d, scale)
    acc, raw = _superposed(values, idx, bp, d, scale)
    return (acc + noise) / torch.clamp_min(raw, vs_min), raw


def check_partial(values, idx, bp, out, offset: int, d: int,
                  scale=None) -> None:
    """Raise on what the partial entry does not take: ``check_inputs``'
    values, indices, bp and scale, and a contiguous 1-D f32 ``out`` on
    their device with room for d columns at ``offset`` before its last
    (varsigma) slot."""
    check_inputs(values, idx, bp, None, d, scale)
    if out.dtype != torch.float32 or out.dim() != 1 or \
            not out.is_contiguous() or out.device != values.device:
        raise ValueError("out must be a contiguous 1-D f32 tensor on the "
                         "values' device")
    if offset < 0 or offset + d > out.numel() - 1:
        raise ValueError(f"d={d} columns at offset={offset} do not fit "
                         f"before the varsigma slot of out "
                         f"({out.numel()} floats)")


def gather_superpose_partial_plain(values, idx, bp, out, offset: int = 0,
                                   *, d: int, scale=None):
    """Plain-torch twin of the partial entry: the sum into ``out[offset:
    offset + d]``, the raw sum of bp into its last slot; returns ``out``."""
    check_partial(values, idx, bp, out, offset, d, scale)
    acc, raw = _superposed(values, idx, bp, d, scale)
    out[offset:offset + d].copy_(acc)
    out[-1:].copy_(raw.reshape(1))
    return out


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
def _lib():
    fn = build.library("gather_superpose").repro_gather_superpose
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _partial_lib():
    fn = build.library("gather_superpose").repro_gather_superpose_partial
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scratch(m: int, d: int, dev):
    """The launch plan and its row-split scratch: (stripe, splits, partial
    (splits, d) f32 | None, arrived (stripes,) i32 | None)."""
    stripe, splits = plan(m, d, build.sm_count(dev.index))
    if -(-d // stripe) > 2**31 - 1:
        raise ValueError(f"d={d} exceeds the kernel's grid")
    partial = arrived = None
    if splits > 1:
        partial = torch.empty((splits, d), dtype=torch.float32, device=dev)
        arrived = torch.empty((-(-d // stripe),), dtype=torch.int32,
                              device=dev)     # zeroed by the launch
    return stripe, splits, partial, arrived


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    stripe, splits, partial, arrived = _scratch(m, d, dev)
    agg = torch.empty((d,), dtype=torch.float32, device=dev)
    raw = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(values.data_ptr(), idx.data_ptr(), bp.data_ptr(),
                    _ptr(scale), noise.data_ptr(), agg.data_ptr(),
                    raw.data_ptr(), _ptr(partial), _ptr(arrived), m, s, d,
                    stripe, splits, float(vs_min), _DTYPES[values.dtype],
                    stream)
    if rc != 0:
        raise RuntimeError(f"gather_superpose kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return agg, raw


def gather_superpose_partial_cuda(values, idx, bp, out, offset: int = 0,
                                  *, d: int, scale=None):
    """Launch the partial entry into ``out``; returns ``out``. Raises on a
    tensor off the GPU or a failed launch; never falls back."""
    global partial_launches
    check_partial(values, idx, bp, out, offset, d, scale)
    if values.device.type != "cuda":
        raise ValueError(f"gather_superpose_partial_cuda needs CUDA "
                         f"tensors, got {values.device}")
    m, s = values.shape
    dev = values.device
    stripe, splits, partial, arrived = _scratch(m, d, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _partial_lib()(values.data_ptr(), idx.data_ptr(),
                            bp.data_ptr(), _ptr(scale),
                            out.data_ptr() + 4 * offset,
                            out.data_ptr() + 4 * (out.numel() - 1),
                            _ptr(partial), _ptr(arrived), m, s, d, stripe,
                            splits, _DTYPES[values.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gather_superpose_partial kernel launch failed: "
                           f"CUDA error {rc}")
    partial_launches += 1
    return out
