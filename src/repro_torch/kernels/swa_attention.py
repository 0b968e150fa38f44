"""Sliding-window flash attention (forward): CUDA kernel + plain twin.

Replaces the TPU kernel
``repro/kernels/swa_attention.py::swa_attention_pallas`` (Pallas body
``_attn_kernel``). q (BH, T, D), k and v (BH, S, D), f32 or bf16; query t
attends to key s where s <= t (if causal) and s > t - W (if a window W is
given), with softmax scale 1/sqrt(D); a row with no key gives 0. Out in
q's dtype.

Bound on the H100: 4 D operations per (query, key) pair inside the band,
against 4 BH T D elements moved (T = S). In f32 they take 67 TFLOP/s on
the CUDA cores, or three TF32 passes at 495 TFLOP/s on the tensor cores.

The kernel (``csrc/swa_attention.cu``) runs both products on the tensor
cores (3xTF32 for f32, bf16 mma for bf16), one block per (bh, query
tile) of 16 rows per warp, with the online softmax in registers and K and V
through a 2-stage cp.async ring. Which key tiles a query tile visits, and
which of them need a mask, is the band plan (``band_plan``): computed here
once per (T, S, W, causal, tiles), kept on the device and read by the
kernel, so the CPU tests hold the very plan the kernel runs against
``band_mask``. Any D up to 256 works (zamba2's 112 included), padded to
the kernel's instance (``tiles``) on chip, never in device memory. No
atomics: repeated calls are bit-identical.

``swa_attention_cuda`` launches the kernel and counts its launches in the
module-level ``launches``; ``swa_attention_plain`` is the full-softmax twin
the CPU path runs and the card holds the kernel against. The GQA repeat
and the (B, T, H, D) layout live in ``ops.swa_attention``.
"""
from __future__ import annotations

import bisect
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.device import f32
from repro_torch.kernels import build

launches = 0

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's instances: head dims padded up to one of these
HEAD_DIMS = (32, 64, 96, 112, 128, 256)


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


def tiles(d: int) -> tuple[int, int, int]:
    """(DP, block_q, block_k) of the kernel instance for head dim d: the
    padded head dim, query rows per block (16 per warp) and keys per tile.
    The kernel refuses a plan made for other tiles."""
    dp = next(x for x in HEAD_DIMS if x >= d)
    return (dp, 128, 64) if dp <= 128 else (dp, 64, 16)


def band_plan(t: int, s: int, window: Optional[int], causal: bool,
              block_q: int, block_k: int) -> torch.Tensor:
    """(ceil(T / block_q), 4) int32: per query tile, (lo, ilo, ihi, hi) in
    key tiles of block_k. The tile visits key tiles [lo, hi), which hold
    every allowed (query, key) pair of its rows; tiles in [ilo, ihi) hold
    allowed pairs only and run with no mask; the rest of [lo, hi) is the
    band's edge. A tile none of whose rows has a key visits nothing."""

    def keys(q):                      # row q's allowed keys [a, b)
        a = 0 if window is None else max(0, q - window + 1)
        return a, (min(s, q + 1) if causal else s)

    # the rows with a key are a prefix [0, qe): both ends rise with q, and
    # a row has a key unless q - W + 1 >= S or (causal) W = 0
    qe = bisect.bisect_left(range(t), True,
                            key=lambda q: keys(q)[0] >= keys(q)[1])
    plan = []
    for q0 in range(0, t, block_q):
        q1 = min(q0 + block_q, t)
        last = min(q1, qe) - 1
        if last < q0:
            plan.append((0, 0, 0, 0))
            continue
        lo, hi = keys(q0)[0] // block_k, -(-keys(last)[1] // block_k)
        if last == q1 - 1:            # every row has a key
            ilo = -(-keys(q1 - 1)[0] // block_k)
            ihi = keys(q0)[1] // block_k
        else:
            ilo = ihi = hi
        ilo = min(max(ilo, lo), hi)
        plan.append((lo, ilo, max(ilo, min(ihi, hi)), hi))
    return torch.tensor(plan, dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _device_plan(t, s, window, causal, block_q, block_k, device):
    return band_plan(t, s, window, causal, block_q, block_k).to(device)


def _lib():
    fn = build.library("swa_attention").repro_swa_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    _, block_q, block_k = tiles(d)
    if bh * -(-t // block_q) > 2**31 - 1:
        raise ValueError(f"BH={bh}, T={t} exceed the kernel's grid")
    fn = _lib()
    plan = _device_plan(t, s, window, bool(causal), block_q, block_k,
                        q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        # the cached plan may leave the cache before this launch has read
        # it: its memory then waits for this stream
        plan.record_stream(stream)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, t, s, d, -1 if window is None else int(window),
                int(causal), f32(1.0 / (d ** 0.5)), _DTYPES[q.dtype],
                plan.data_ptr(), block_q, block_k, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swa_attention kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
