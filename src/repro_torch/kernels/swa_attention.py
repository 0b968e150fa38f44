"""Sliding-window flash attention, forward and backward: CUDA kernels +
plain twins.

The forward replaces the TPU kernel
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
atomics: repeated calls are bit-identical. With ``return_lse`` the kernel
also writes each row's log-sum-exp (f32, (BH, T)) for the backward;
serving passes a null pointer and its output is unchanged.

The backward (``swa_attention_bwd_cuda``, same source) replaces no TPU
kernel: the reference trains attention through its plain ``_flash``
custom VJP (``repro/models/layers.py`` ``_flash_bwd``), whose math it
runs: P recomputed from q, k and the log-sum-exp, D = rowsum(dout o
out), dV = P^T dout, dS = P o (dout V^T - D) scale, dQ = dS K, dK = dS^T
Q. Bound: 10 D operations a pair in the band (14 D as run), every
product on the tensor cores (f32 in three TF32 passes, bf16 one mma, two
where P or dS is split into bf16 hi + lo). Two kernels, no float atomics:
dQ per (bh, query tile) over the key tiles of ``band_plan``, dK and dV
per (bh, key tile) over the query tiles of ``band_plan_t``, the plan
transposed, which also names each key tile's interior query tiles (no
mask there); both plans at 64 x 64 tiles, a block taking one or two of
them. P and dS stay in the mma's registers; K and V (pass 1) or Q and
dO (pass 2) stream through a cp.async ring in the inputs' dtype.
D up to 128. A row with no key gets zero gradients.
``swa_attention_train`` puts both under autograd.

``swa_attention_cuda`` and ``swa_attention_bwd_cuda`` launch the kernels
and count their launches in the module-level ``launches`` and
``bwd_launches``; ``swa_attention_plain`` and ``swa_attention_bwd_plain``
are the twins the CPU path runs and the card holds the kernels against.
The GQA repeat and the (B, T, H, D) layout live in ``ops.swa_attention``.
"""
from __future__ import annotations

import bisect
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.device import f32
from repro_torch.kernels import build

launches = 0           # forward kernel launches
bwd_launches = 0       # backward launches (one per call: two kernels)

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's instances: head dims padded up to one of these
HEAD_DIMS = (32, 64, 96, 112, 128, 256)
# the backward's tiles (query rows and keys) and its largest head dim
BWD_BLOCK = 64
BWD_MAX_HEAD_DIM = 128


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


def tracks_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def swa_attention_plain(q, k, v, *, window: Optional[int] = None,
                        causal: bool = True, return_lse: bool = False):
    """Plain-torch twin, the reference's full-softmax oracle in f32:
    (BH, T, D) in q's dtype, and with ``return_lse`` each row's f32
    log-sum-exp of its scaled logits (BH, T) (-1e30 for a row with no
    key), as the kernel writes it for the backward. The (BH, T, S) logits
    are formed once and updated in place; where autograd tracks q, k or v
    the probabilities are masked out of place, so torch's own backward
    runs through the twin."""
    check_inputs(q, k, v, window)
    t, s = q.shape[1], k.shape[1]
    mask = band_mask(t, s, window, causal, q.device)
    logits = torch.bmm(q.float(), k.float().transpose(1, 2))
    logits.mul_(f32(1.0 / (q.shape[-1] ** 0.5)))
    logits.masked_fill_(~mask, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1) if return_lse else None
    probs = torch.softmax(logits, dim=-1)
    del logits
    empty = ~mask.any(-1, keepdim=True)
    if tracks_grad(q, k, v):
        probs = probs.masked_fill(empty, 0.0)
    else:
        probs.masked_fill_(empty, 0.0)
    out = torch.bmm(probs, v.float()).to(q.dtype)
    return (out, lse) if return_lse else out


def check_bwd_inputs(q, k, v, out, dout, lse, window: Optional[int]) -> None:
    """Raise on anything the backward does not take: ``check_inputs``' q,
    k, v; out and dout of q's shape and dtype; lse (BH, T) f32; all
    contiguous on one device; the head dim at most ``BWD_MAX_HEAD_DIM``."""
    check_inputs(q, k, v, window)
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype}: expected "
                             f"q's {tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected "
                         f"{tuple(q.shape[:2])} float32")
    for x in (out, dout, lse):
        if not x.is_contiguous() or x.device != q.device:
            raise ValueError("swa_attention backward inputs must be "
                             "contiguous and on q's device")
    if q.shape[2] > BWD_MAX_HEAD_DIM:
        raise ValueError(f"swa_attention backward: head dim {q.shape[2]} > "
                         f"{BWD_MAX_HEAD_DIM} is not taken (the ported "
                         f"attention families use 64, 80, 112 and 128)")


def swa_attention_bwd_plain(q, k, v, out, dout, lse, *,
                            window: Optional[int] = None,
                            causal: bool = True):
    """Plain-torch twin of the backward: the reference's ``_flash_bwd``
    on the whole (BH, T, S) matrix, in f32. P = exp(scale q k^T - lse)
    inside the band and 0 outside it (so a row with no key gets zero
    gradients), D = rowsum(dout o out), dV = P^T dout, dS = P o (dout V^T
    - D) scale, dQ = dS K, dK = dS^T Q. Returns (dq, dk, dv) in the
    inputs' dtype."""
    check_bwd_inputs(q, k, v, out, dout, lse, window)
    t, s = q.shape[1], k.shape[1]
    scale = f32(1.0 / (q.shape[-1] ** 0.5))
    mask = band_mask(t, s, window, causal, q.device)
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    p = torch.bmm(qf * scale, kf.transpose(1, 2))
    p = torch.where(mask, torch.exp(p - lse[..., None]), 0.0)
    dv = torch.bmm(p.transpose(1, 2), do)
    ds = torch.bmm(do, vf.transpose(1, 2))
    delta = (do * out.float()).sum(-1)
    ds = p * (ds - delta[..., None]) * scale
    del p
    dq = torch.bmm(ds, kf)
    dk = torch.bmm(ds.transpose(1, 2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def band_plan_t(t: int, s: int, window: Optional[int], causal: bool,
                block_q: int, block_k: int) -> torch.Tensor:
    """The band plan transposed, for the backward's dK / dV pass:
    (ceil(S / block_k), 4) int32, per key tile (lo, ilo, ihi, hi) in query
    tiles of block_q. The tile's keys are seen by queries in tiles [lo, hi)
    only; tiles in [ilo, ihi) lie inside T, face a key tile inside S and
    hold allowed pairs only, so they run with no mask; the rest of [lo, hi)
    is the band's edge. A key tile no query sees visits nothing."""

    def queries(j):                   # key j's queries [a, b)
        a = j if causal else 0
        return a, (t if window is None else min(t, j + window))

    plan = []
    for k0 in range(0, s, block_k):
        k1 = min(k0 + block_k, s)
        spans = [queries(j) for j in range(k0, k1)]
        spans = [(a, b) for a, b in spans if a < b]
        if not spans:
            plan.append((0, 0, 0, 0))
            continue
        lo = min(a for a, _ in spans) // block_q
        hi = -(-max(b for _, b in spans) // block_q)
        if k1 == k0 + block_k:
            # the queries that see every key of the tile: from the last
            # key's first query to the first key's end
            ilo = -(-queries(k1 - 1)[0] // block_q)
            ihi = queries(k0)[1] // block_q
        else:
            ilo = ihi = hi
        ilo = min(max(ilo, lo), hi)
        plan.append((lo, ilo, max(ilo, min(ihi, hi)), hi))
    return torch.tensor(plan, dtype=torch.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _device_plan(t, s, window, causal, block_q, block_k, device):
    return band_plan(t, s, window, causal, block_q, block_k).to(device)


@functools.lru_cache(maxsize=64)
def _device_plan_t(t, s, window, causal, block_q, block_k, device):
    return band_plan_t(t, s, window, causal, block_q, block_k).to(device)


def _lib():
    fn = build.library("swa_attention").repro_swa_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    fn = build.library("swa_attention").repro_swa_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, what: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}")


def swa_attention_cuda(q, k, v, *, window: Optional[int] = None,
                       causal: bool = True, return_lse: bool = False):
    """Launch the CUDA kernel: (BH, T, D) in q's dtype, as the twin, and
    with ``return_lse`` the (BH, T) f32 log-sum-exp the backward reads
    (without it the kernel is handed a null pointer and writes the output
    only). Raises on a tensor off the GPU or a failed launch; never falls
    back."""
    global launches
    check_inputs(q, k, v, window)
    _check_cuda(q, "swa_attention_cuda")
    bh, t, d = q.shape
    s = k.shape[1]
    _, block_q, block_k = tiles(d)
    if bh * -(-t // block_q) > 2**31 - 1:
        raise ValueError(f"BH={bh}, T={t} exceed the kernel's grid")
    fn = _lib()
    plan = _device_plan(t, s, window, bool(causal), block_q, block_k,
                        q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((bh, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        # the cached plan may leave the cache before this launch has read
        # it: its memory then waits for this stream
        plan.record_stream(stream)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                0 if lse is None else lse.data_ptr(),
                bh, t, s, d, -1 if window is None else int(window),
                int(causal), f32(1.0 / (d ** 0.5)), _DTYPES[q.dtype],
                plan.data_ptr(), block_q, block_k, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swa_attention kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return (out, lse) if return_lse else out


def swa_attention_bwd_cuda(q, k, v, out, dout, lse, *,
                           window: Optional[int] = None,
                           causal: bool = True):
    """Launch the backward (its two kernels, one count in
    ``bwd_launches``): (dq, dk, dv) in the inputs' dtype, as
    ``swa_attention_bwd_plain``. Raises on a tensor off the GPU or a
    failed launch; never falls back."""
    global bwd_launches
    check_bwd_inputs(q, k, v, out, dout, lse, window)
    _check_cuda(q, "swa_attention_bwd_cuda")
    bh, t, d = q.shape
    s = k.shape[1]
    plans = [fn(t, s, window, bool(causal), BWD_BLOCK, BWD_BLOCK, q.device)
             for fn in (_device_plan, _device_plan_t)]
    delta = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        for plan in plans:
            plan.record_stream(stream)
        rc = _bwd_lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, t, s, d,
            -1 if window is None else int(window), int(causal),
            f32(1.0 / (d ** 0.5)), _DTYPES[q.dtype], plans[0].data_ptr(),
            plans[1].data_ptr(), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swa_attention backward launch failed: CUDA "
                           f"error {rc}")
    bwd_launches += 1
    return dq, dk, dv


class _SwaAttention(torch.autograd.Function):
    """The kernel under autograd: the forward writes the log-sum-exp, the
    backward kernel reads it."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        out, lse = swa_attention_cuda(q, k, v, window=window, causal=causal,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = swa_attention_bwd_cuda(
            q, k, v, out, dout.contiguous(), lse, window=ctx.window,
            causal=ctx.causal)
        return dq, dk, dv, None, None


def swa_attention_train(q, k, v, *, window: Optional[int] = None,
                        causal: bool = True):
    """``swa_attention_cuda`` differentiable in q, k and v: the forward
    kernel with the log-sum-exp, then, in the backward, the backward
    kernel (CUDA tensors only)."""
    _check_cuda(q, "swa_attention_train")
    return _SwaAttention.apply(q, k, v, window, causal)
