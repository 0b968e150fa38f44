"""Sliding-window flash attention (forward): CUDA kernel + plain twin.

Replaces the TPU kernel
``repro/kernels/swa_attention.py::swa_attention_pallas`` (Pallas body
``_attn_kernel``). q (BH, T, D), k and v (BH, S, D), f32 or bf16; query t
attends to key s where s <= t (if causal) and s > t - W (if a window W is
given), with softmax scale 1/sqrt(D); a row with no key gives 0. Out in
q's dtype.

Bound on the H100: f32 operations. The products run in full f32 off the
tensor cores (TF32 is off in the port), 4 D operations per (query, key)
pair inside the band, against 4 BH T D elements moved (T = S).

The kernel (``csrc/swa_attention.cu``) gives each block one (bh, 64-query
tile) and keeps the running (m, l, acc) of the online softmax in f32
registers. The block visits only the 64-key tiles that intersect the band
of its rows, ``(q0 - W, q1)`` when causal, so a query tile costs
O(W + 64) and not O(T), the structure the Pallas index map encodes. Ragged
T and S are masked without padded copies; any D up to 256 works (zamba2's
112 included). No atomics: repeated calls are bit-identical.

``swa_attention_cuda`` launches the kernel and counts its launches in the
module-level ``launches``; ``swa_attention_plain`` is the full-softmax twin
the CPU path runs and the card holds the kernel against. The GQA repeat
and the (B, T, H, D) layout live in ``ops.swa_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.device import f32
from repro_torch.kernels import build

launches = 0

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(q, k, v, window: Optional[int]) -> None:
    """Raise on anything the kernel does not take: q (BH, T, D), k and v
    (BH, S, D) of one dtype, f32 or bf16, contiguous, on one device;
    1 <= D <= 256; window None or >= 0."""
    if q.dim() != 3 or min(q.shape) < 1:
        raise ValueError(f"q must be a non-empty (BH, T, D) tensor, got "
                         f"shape {tuple(q.shape)}")
    bh, _, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if (t.dim() != 3 or t.shape[0] != bh or t.shape[2] != d
                or t.shape[1] < 1):
            raise ValueError(f"{name} shape {tuple(t.shape)}: expected "
                             f"({bh}, S, {d})")
    if k.shape != v.shape:
        raise ValueError(f"k shape {tuple(k.shape)} != v shape "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        f"expected one of float32, bfloat16")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if window is not None and window < 0:
        raise ValueError(f"window={window}: expected None or >= 0")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("swa_attention inputs must be contiguous")
        if t.device != q.device:
            raise ValueError(f"swa_attention inputs span devices {t.device} "
                             f"and {q.device}")


def band_mask(t: int, s: int, window: Optional[int], causal: bool, device):
    """(T, S) bool: True where query t may attend to key s."""
    qp = torch.arange(t, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def swa_attention_plain(q, k, v, *, window: Optional[int] = None,
                        causal: bool = True):
    """Plain-torch twin, the reference's full-softmax oracle in f32:
    (BH, T, D) in q's dtype. The (BH, T, S) logits are formed once and
    updated in place."""
    check_inputs(q, k, v, window)
    t, s = q.shape[1], k.shape[1]
    mask = band_mask(t, s, window, causal, q.device)
    logits = torch.bmm(q.float(), k.float().transpose(1, 2))
    logits.mul_(f32(1.0 / (q.shape[-1] ** 0.5)))
    logits.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    del logits
    probs.masked_fill_(~mask.any(-1, keepdim=True), 0.0)
    return torch.bmm(probs, v.float()).to(q.dtype)


def _lib():
    fn = build.library("swa_attention").repro_swa_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def swa_attention_cuda(q, k, v, *, window: Optional[int] = None,
                       causal: bool = True):
    """Launch the CUDA kernel: (BH, T, D) in q's dtype, as the twin.
    Raises on a tensor off the GPU or a failed launch; never falls back."""
    global launches
    check_inputs(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    bh, t, d = q.shape
    s = k.shape[1]
    if bh * ((t + 63) // 64) > 2**31 - 1:
        raise ValueError(f"BH={bh}, T={t} exceed the kernel's grid")
    fn = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, t, s, d, -1 if window is None else int(window),
                int(causal), f32(1.0 / (d ** 0.5)), _DTYPES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"swa_attention kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
