"""AirComp superposition over the (K, D) payload plane: two CUDA kernels on
one body (``csrc/aircomp_sum.cu``), each with its plain twin and its launch
counter.

Sweep 2 of the fused round, ``superpose_normalize``, replaces the TPU kernel
``repro/kernels/aircomp_sum.py::superpose_normalize_pallas`` (Pallas body
``_superpose_kernel``). With bp = powers * mask, eqs. (6)+(8) in one pass
over the (K, D) payload plane:

    agg      = (sum_k bp_k x_k + noise) / max(sum_k bp_k, vs_min)
    varsigma = sum_k bp_k                               (raw, unclamped)

Bound on the H100: memory bytes (K*D*s read once, one FMA each). At the
paper's sizes the plane is a few MB, so the call is bound by latency. The
kernel (``csrc/aircomp_sum.cu``) runs a grid of column tiles (``plan``): a
warp covers 32 * vec columns with loads as wide as the row pitch and x's
alignment allow, the 16 or 32 warps of a block split the rows and each
keeps 8 row loads (4 of 16 bytes) in flight, and the block adds its warps
in order, the noise, and divides. Every block sums bp in the same order,
and tile 0's writes varsigma. No scratch, no counter and no float
atomics, so the result is identical from run to run, as the scanned
reference round's is.

``superpose_normalize_cuda`` launches the kernel and counts its launches in
the module-level ``launches``; ``superpose_normalize_plain`` is the
plain-torch twin the CPU path runs and the card holds the kernel against.

``aircomp_sum`` replaces the TPU kernel
``repro/kernels/aircomp_sum.py::aircomp_sum_pallas`` (Pallas body
``_kernel``), the host-path server's ``use_kernel=True`` route. With bp
given (already masked):

    agg = (sum_k bp_k x_k + noise) / max(sum_k bp_k, 1e-12)

Same bound (bytes: 4 (K D + K + 2 D) in f32), the same body and plan as
sweep 2; the clamped varsigma is computed inside the kernel and only the
f32 aggregate comes back. The Pallas wrapper pads D to 512 with a copy;
this kernel masks the ragged edge and copies nothing. ``aircomp_sum_cuda``
counts its launches in ``aircomp_sum_launches``; ``aircomp_sum_plain`` is
its twin.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0                # superpose_normalize_cuda launches
aircomp_sum_launches = 0    # aircomp_sum_cuda launches

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


@functools.lru_cache(maxsize=None)
def plan(k: int, d: int, itemsize: int, align: int) -> tuple[int, int]:
    """``(vec, warps)``: the widest load (``align``: x's pointer
    alignment), and 16 warps a block, or 32 above K = 256, so a warp keeps
    at most 8 rows in one round trip up to K = 128. Block t takes the
    columns [t * 32 * vec, (t + 1) * 32 * vec) & [0, d) of every row."""
    return build.load_width(d, itemsize, align), 16 if k <= 256 else 32


def device_plan(stacked) -> tuple[int, int]:
    """The plan for this CUDA payload: ``(vec, warps)``."""
    k, d = stacked.shape
    return plan(k, d, stacked.element_size(), build.alignment(stacked))


@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.library("aircomp_sum").repro_superpose_normalize
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
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
    vec, warps = device_plan(stacked)
    dev = stacked.device
    agg = torch.empty((d,), dtype=torch.float32, device=dev)
    raw = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(stacked.data_ptr(), powers.data_ptr(), mask.data_ptr(),
                    noise.data_ptr(), agg.data_ptr(), raw.data_ptr(), k, d,
                    float(vs_min), int(stacked.dtype == torch.bfloat16),
                    stream, vec, warps)
    if rc != 0:
        raise RuntimeError(f"superpose_normalize kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return agg, raw


def aircomp_sum_plain(stacked, bp, noise):
    """Plain-torch twin: the (D,) f32 aggregate."""
    check_inputs(stacked, bp, bp, noise)        # bp in the powers' place
    acc = bp @ stacked.float()
    return (acc + noise) / torch.clamp_min(bp.sum(), 1e-12)


@functools.lru_cache(maxsize=None)
def _aircomp_lib():
    fn = build.library("aircomp_sum").repro_aircomp_sum
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def aircomp_sum_cuda(stacked, bp, noise):
    """Launch the aircomp_sum kernel: the (D,) f32 aggregate. Raises on a
    tensor off the GPU or a failed launch; never falls back."""
    global aircomp_sum_launches
    check_inputs(stacked, bp, bp, noise)        # bp in the powers' place
    if stacked.device.type != "cuda":
        raise ValueError(f"aircomp_sum_cuda needs CUDA tensors, got "
                         f"{stacked.device}")
    k, d = stacked.shape
    vec, warps = device_plan(stacked)
    dev = stacked.device
    agg = torch.empty((d,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _aircomp_lib()(stacked.data_ptr(), bp.data_ptr(),
                            noise.data_ptr(), agg.data_ptr(), k, d,
                            int(stacked.dtype == torch.bfloat16), stream,
                            vec, warps)
    if rc != 0:
        raise RuntimeError(f"aircomp_sum kernel launch failed: CUDA error "
                           f"{rc}")
    aircomp_sum_launches += 1
    return agg
