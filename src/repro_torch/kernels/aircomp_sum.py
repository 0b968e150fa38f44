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

``aircomp_partial`` is the local half of the sharded round's
superposition, which the reference computes as plain ``dot_general``
(``repro/kernels/aircomp_sum.py::aircomp_partial_tree``; it replaces no
Pallas kernel). With bp already masked:

    out[place(j)] = sum_k bp_k x[k, j],   out[-1] = sum_k bp_k  (optional)

into the flat (d_total + 1,) f32 partial that one all-reduce sends:
column j of the leaf lands at ``offset + (j // seg) * pitch + j % seg``,
which is ``offset + j`` for a whole leaf (seg = pitch = D) and the
strided place of a TP rank's block inside the full leaf otherwise. No
noise, no division. Same body and plan as sweep 2, same bytes bound (4 (K
D + K + D) in f32, 2 K D + 4 (K + D) in bf16). ``aircomp_partial_cuda``
counts its launches in ``partial_launches``; ``aircomp_partial_plain``
(``bp @ x.float()`` into the same places) is its twin.
``aircomp_partial_tree`` / ``aircomp_partial_tree_tp`` /
``aircomp_finalize_tree`` are the reference's tree entries around it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

launches = 0                # superpose_normalize_cuda launches
aircomp_sum_launches = 0    # aircomp_sum_cuda launches
partial_launches = 0        # aircomp_partial_cuda launches

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


def check_partial(stacked, bp, out, offset: int, seg: int,
                  pitch: int) -> None:
    """Raise on what the partial entry does not take: a (K, D) f32/bf16
    payload, (K,) f32 bp, a flat f32 ``out`` with room for every placed
    column before its last (varsigma) slot, seg dividing D, pitch >= seg;
    all contiguous and on one device."""
    if stacked.dim() != 2 or stacked.shape[0] < 1 or stacked.shape[1] < 1:
        raise ValueError(f"stacked must be a non-empty (K, D) matrix, got "
                         f"shape {tuple(stacked.shape)}")
    if stacked.dtype not in _FLOATS:
        raise TypeError(f"stacked dtype {stacked.dtype}: expected float32 "
                        f"or bfloat16")
    k, d = stacked.shape
    if bp.dtype != torch.float32 or tuple(bp.shape) != (k,):
        raise ValueError(f"bp must be ({k},) f32, got {tuple(bp.shape)} "
                         f"{bp.dtype}")
    for t in (stacked, bp):
        if not t.is_contiguous() or t.device != out.device:
            raise ValueError("aircomp_partial inputs must be contiguous and "
                             "on out's device")
    if out.dtype != torch.float32 or out.dim() != 1 or \
            not out.is_contiguous() or out.device != stacked.device:
        raise ValueError("out must be a contiguous 1-D f32 tensor on the "
                         "payload's device")
    if seg < 1 or d % seg or pitch < seg or offset < 0:
        raise ValueError(f"placement offset={offset}, seg={seg}, "
                         f"pitch={pitch} for D={d}")
    end = offset + (d // seg - 1) * pitch + seg
    if end > out.numel() - 1:
        raise ValueError(f"the placed columns end at {end}, past the "
                         f"{out.numel() - 1} model slots of out")


def _placed(out, offset: int, d: int, seg: int, pitch: int):
    """The (D / seg, seg) strided view of ``out`` the columns land in."""
    return out.as_strided((d // seg, seg), (pitch, 1),
                          out.storage_offset() + offset)


def aircomp_partial_plain(stacked, bp, out, offset: int = 0, *,
                          seg: int | None = None, pitch: int | None = None,
                          write_varsigma: bool = True):
    """Plain-torch twin: ``bp @ x.float()`` into ``out``'s placed columns,
    the raw sum of bp into its last slot; returns ``out``."""
    d = stacked.shape[1]
    seg = d if seg is None else seg
    pitch = seg if pitch is None else pitch
    check_partial(stacked, bp, out, offset, seg, pitch)
    acc = bp @ stacked.float()
    _placed(out, offset, d, seg, pitch).copy_(acc.reshape(d // seg, seg))
    if write_varsigma:
        out[-1:].copy_(bp.sum().reshape(1))
    return out


@functools.lru_cache(maxsize=None)
def _partial_lib():
    fn = build.library("aircomp_sum").repro_aircomp_partial
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def aircomp_partial_cuda(stacked, bp, out, offset: int = 0, *,
                         seg: int | None = None, pitch: int | None = None,
                         write_varsigma: bool = True):
    """Launch the partial entry into ``out``; returns ``out``. Raises on a
    tensor off the GPU or a failed launch; never falls back."""
    global partial_launches
    d = stacked.shape[1]
    seg = d if seg is None else seg
    pitch = seg if pitch is None else pitch
    check_partial(stacked, bp, out, offset, seg, pitch)
    if stacked.device.type != "cuda":
        raise ValueError(f"aircomp_partial_cuda needs CUDA tensors, got "
                         f"{stacked.device}")
    k = stacked.shape[0]
    vec, warps = device_plan(stacked)
    dev = stacked.device
    vs_ptr = out.data_ptr() + 4 * (out.numel() - 1) if write_varsigma else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _partial_lib()(stacked.data_ptr(), bp.data_ptr(),
                            out.data_ptr() + 4 * offset, vs_ptr or None, k,
                            d, seg, pitch,
                            int(stacked.dtype == torch.bfloat16), stream,
                            vec, warps)
    if rc != 0:
        raise RuntimeError(f"aircomp_partial kernel launch failed: CUDA error "
                           f"{rc}")
    partial_launches += 1
    return out


def aircomp_partial_tree(stacked_leaves, bp):
    """This rank's flat superposition partial: each (K, ...) leaf's
    ``bp``-weighted sum over its rows at its place in the flattened model,
    the raw sum of bp appended; one (d_total + 1,) f32 vector
    (``ops.aircomp_partial``, one launch a leaf on the card). Rows with
    bp = 0 add exact zeros."""
    from repro_torch.kernels import ops
    from repro_torch.tree import leaf2d
    sizes = [leaf[0].numel() for leaf in stacked_leaves]
    out = torch.empty((sum(sizes) + 1,), dtype=torch.float32,
                      device=bp.device)
    off = 0
    for i, (leaf, size) in enumerate(zip(stacked_leaves, sizes)):
        ops.aircomp_partial(leaf2d(leaf), bp, out, off,
                            write_varsigma=i == 0)
        off += size
    return out


def aircomp_partial_tree_tp(stacked_leaves, bp, tp):
    """``aircomp_partial_tree`` of TP-local blocks: each split leaf's sum
    embedded at this rank's block of the FULL leaf in the full flat model
    vector (zeros elsewhere); replicated leaves and the varsigma slot are
    written on the lead TP rank only, so one all-reduce over clients x TP
    counts them once. Returns the (d_total_full + 1,) f32 partial."""
    from repro_torch.kernels import ops
    from repro_torch.sharding.tp import tp_full_shapes
    from repro_torch.tree import leaf2d
    full = tp_full_shapes(stacked_leaves, tp)
    sizes = [math.prod(shape[1:]) for shape in full]
    out = torch.zeros((sum(sizes) + 1,), dtype=torch.float32,
                      device=bp.device)
    lead = tp.index == 0
    off, vs_done = 0, False
    for leaf, dim, shape, size in zip(stacked_leaves, tp.leaf_dims, full,
                                      sizes):
        if dim >= 0:
            seg = math.prod(leaf.shape[dim + 1:])
            pitch = seg * tp.shards
            ops.aircomp_partial(leaf2d(leaf), bp, out,
                                off + tp.index * seg, seg=seg, pitch=pitch,
                                write_varsigma=lead and not vs_done)
            vs_done = vs_done or lead
        elif lead:
            ops.aircomp_partial(leaf2d(leaf), bp, out, off,
                                write_varsigma=not vs_done)
            vs_done = True
        off += size
    return out


def aircomp_finalize_tree(flat, shapes, noise_leaves, vs_min: float):
    """From the reduced flat partial: the clamped varsigma, and per leaf
    of (K, ...) ``shapes`` the (sum + noise) / varsigma aggregate in f32,
    with the noise joining once here (``noise_leaves`` None: a noiseless
    channel). Returns (list of aggregate leaves, varsigma)."""
    varsigma = torch.clamp_min(flat[-1], vs_min)
    out, off = [], 0
    for i, shape in enumerate(shapes):
        size = math.prod(shape[1:])
        acc = flat[off:off + size]
        off += size
        if noise_leaves is not None:
            acc = acc + noise_leaves[i].reshape(-1)
        out.append((acc / varsigma).reshape(shape[1:]))
    return out, varsigma
