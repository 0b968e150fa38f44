"""Mamba2 SSD intra-chunk part: CUDA kernel + plain twin.

Replaces the TPU kernel ``repro/kernels/ssd_chunk.py::ssd_intra_chunk_pallas``
(Pallas body ``_kernel``). For each cell g of G = batch * chunks * heads,
with cum (G, Q) the cumulative log-decay inside the chunk:

    decay[i, j] = exp(clip(cum_i - cum_j, -60, 0))  where i >= j, else 0
    y           = ((C B^T) * decay) @ xdt               (Q, P), xdt's dtype
    tail[j]     = exp(clip(cum_{Q-1} - cum_j, -60, 0))
    state       = (B * tail)^T @ xdt                    (N, P) f32
    chunk_decay = exp(clip(cum_{Q-1}, -60, 0))          f32

Bound on the H100: f32 operations (the products run in full f32, off the
tensor cores, since the port turns TF32 off). At the full-width layer
shape (G, Q, N, P) = (1024, 256, 128, 64) the causal half of the two
(Q, Q) products and the state product are 17.3 GFLOP against 437 MB moved.

The kernel (``csrc/ssd_chunk.cu``) tiles what one Pallas grid cell kept
resident: a cell's B, C and (Q, Q) scores do not fit in a block's shared
memory at full width. One block per (cell, 64-row query tile) walks the
key tiles up to the diagonal, forms its rows of C B^T in registers, decays
and masks them, and multiplies by xdt while the tile is resident; other
blocks of the same launch form the state's (64 x 64) tiles and the chunk
decay. Sums run in a fixed order in f32 with no atomics, so repeated calls
are bit-identical. Ragged Q, N, P are masked; nothing is padded.

``ssd_intra_chunk_cuda`` launches the kernel and counts its launches in
the module-level ``launches``; ``ssd_intra_chunk_plain`` is the plain-torch
twin the CPU path runs and the card holds the kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(cum, b, c, xdt) -> None:
    """Raise on anything the kernel does not take: cum (G, Q) f32; b, c
    (G, Q, N) and xdt (G, Q, P) of one dtype, f32 or bf16; all contiguous
    and on one device."""
    if cum.dim() != 2 or cum.shape[0] < 1 or cum.shape[1] < 1:
        raise ValueError(f"cum must be a non-empty (G, Q) matrix, got shape "
                         f"{tuple(cum.shape)}")
    if cum.dtype != torch.float32:
        raise TypeError(f"cum dtype {cum.dtype}: expected float32")
    g, q = cum.shape
    for name, t in (("b", b), ("c", c), ("xdt", xdt)):
        if t.dim() != 3 or tuple(t.shape[:2]) != (g, q) or t.shape[2] < 1:
            raise ValueError(f"{name} shape {tuple(t.shape)}: expected "
                             f"({g}, {q}, >=1)")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {t.dtype}: expected float32 or "
                            f"bfloat16")
    if not b.dtype == c.dtype == xdt.dtype:
        raise TypeError(f"b, c, xdt dtypes differ: {b.dtype}, {c.dtype}, "
                        f"{xdt.dtype}")
    if b.shape != c.shape:
        raise ValueError(f"b shape {tuple(b.shape)} != c shape "
                         f"{tuple(c.shape)}")
    for t in (cum, b, c, xdt):
        if not t.is_contiguous():
            raise ValueError("ssd_intra_chunk inputs must be contiguous")
        if t.device != cum.device:
            raise ValueError(f"ssd_intra_chunk inputs span devices "
                             f"{t.device} and {cum.device}")


def ssd_intra_chunk_plain(cum, b, c, xdt):
    """Plain-torch twin: ``(y (G, Q, P) in xdt's dtype, state (G, N, P)
    f32, chunk_decay (G,) f32)``, the reference's oracle in f32."""
    check_inputs(cum, b, c, xdt)
    q = cum.shape[1]
    b32, c32, x32 = b.float(), c.float(), xdt.float()
    decay = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :],
                                  -60.0, 0.0))
    causal = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    scores = torch.bmm(c32, b32.transpose(1, 2))
    scores = torch.where(causal, scores * decay, 0.0)
    y = torch.bmm(scores, x32)
    tail = torch.exp(torch.clamp(cum[:, -1:] - cum, -60.0, 0.0))
    state = torch.bmm((b32 * tail[..., None]).transpose(1, 2), x32)
    chunk_decay = torch.exp(torch.clamp(cum[:, -1], -60.0, 0.0))
    return y.to(xdt.dtype), state, chunk_decay


def _lib():
    fn = build.library("ssd_chunk").repro_ssd_intra_chunk
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk_cuda(cum, b, c, xdt):
    """Launch the CUDA kernel: ``(y, state, chunk_decay)`` as the twin.
    Raises on a tensor off the GPU or a failed launch; never falls back."""
    global launches
    check_inputs(cum, b, c, xdt)
    if cum.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_cuda needs CUDA tensors, got "
                         f"{cum.device}")
    g, q = cum.shape
    n, p = b.shape[2], xdt.shape[2]
    if g > 2**31 - 1:
        raise ValueError(f"G={g} exceeds the kernel's grid")
    fn = _lib()
    y = torch.empty((g, q, p), dtype=xdt.dtype, device=cum.device)
    state = torch.empty((g, n, p), dtype=torch.float32, device=cum.device)
    decay = torch.empty((g,), dtype=torch.float32, device=cum.device)
    with torch.cuda.device(cum.device):
        stream = torch.cuda.current_stream(cum.device).cuda_stream
        rc = fn(cum.data_ptr(), b.data_ptr(), c.data_ptr(), xdt.data_ptr(),
                y.data_ptr(), state.data_ptr(), decay.data_ptr(), g, q, n, p,
                _DTYPES[xdt.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return y, state, decay
