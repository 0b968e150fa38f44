"""Mamba2 SSD intra-chunk part: CUDA kernel + plain twin, grouped.

Replaces the TPU kernel ``repro/kernels/ssd_chunk.py::ssd_intra_chunk_pallas``
(Pallas body ``_kernel``). For each chunk cell (batch, chunk) and head h of
group g = h // rep (rep = H / G heads share one B and one C):

    decay[i, j] = exp(clip(cum_i - cum_j, -60, 0))  where i >= j, else 0
    y_h         = ((C_g B_g^T) * decay) @ xdt_h         (Q, P), xdt's dtype
    tail[j]     = exp(clip(cum_{Q-1} - cum_j, -60, 0))
    state_h     = xdt_h^T @ (B_g * tail)                (P, N) f32
    chunk_decay = exp(clip(cum_{Q-1}, -60, 0))          f32

``ssd_intra_chunk_grouped`` takes the layouts ``ssd_chunked`` has at hand:
cum (Bz, NC, Q, H) f32, B and C (Bz, NC, Q, G, N) as strided views of the
conv output (only N must be contiguous), xdt (Bz, NC, Q, H, P); it returns
y (Bz, NC, Q, H, P), state (Bz, NC, H, P, N) and chunk_decay (Bz, NC, H).
The reference-shaped ``ssd_intra_chunk`` (cum (G, Q); b, c (G, Q, N); xdt
(G, Q, P), per head) is a thin adapter onto the same kernel: the G cells as
a batch with H = G = 1; its state is the (G, N, P) transposed view.

Bound on the H100: at mamba2-370m's prefill layer (Bz 8, NC 4, H 32, G 1,
Q 256, N 128, P 64) 8.94 GFLOP against 177 MB. The kernel
(``csrc/ssd_chunk.cu``) forms C B^T once per group and shares it among the
group's heads. The state product runs on the tensor cores in 3xTF32 (each
operand split into two TF32 halves, three products accumulated in f32:
f32 accuracy); the two score products run as f32 FMA chains in key
order, the twin's order, since 3xTF32 there missed the twin's 2e-5 by
summation order alone. Sums run in a fixed order with no atomics, so
repeated calls are bit-identical. Ragged Q, N, P are masked; nothing is
padded.

``ssd_intra_chunk_grouped_cuda`` launches the kernel and counts its
launches in the module-level ``launches``; ``ssd_intra_chunk_grouped_plain``
is the plain-torch twin the CPU path runs and the card holds the kernel
against (it broadcasts B and C over the heads).

The backward. The reference has no Pallas kernel for it: ``jax.grad``
differentiates ``ssd_chunked``'s plain jnp (``repro/models/ssm.py:81``).
``ssd_intra_chunk_grouped_bwd_cuda`` launches ``csrc/ssd_chunk_bwd.cu``
(three kernels, one count in ``bwd_launches``): from the saved cum, B, C,
xdt and the outputs' gradients it recomputes C B^T and the decays and
returns (dcum, dB, dC, dxdt). Every product runs on the tensor cores
(``mma.sync``: 3xTF32 in f32; in bf16 one m16n8k16 pass, two where an
operand is f32 and split into bf16 hi + lo), its tiles staged through a
cp.async ring where ``_bwd_vec16`` holds; the heads of a group sum dS in
subsets of ``bwd_heads_per_block`` before the dB and dC products, no
atomics (bit-identical on repeat); ``bwd_blocks`` counts its blocks. At
mamba2-370m's train microbatch (Bz 2, NC 16, H 32, Q 256, N 128, P 64)
that is 18.2 GFLOP: 0.11 ms on an H100 in f32-accurate 3xTF32 (495 / 3
TFLOP/s). ``ssd_intra_chunk_grouped_bwd_plain`` is its twin,
the formulas written out. ``ssd_intra_chunk_grouped_train`` (and the
reference-shaped ``ssd_intra_chunk_train``) run the forward kernel under
``_SsdIntraChunk``, a ``torch.autograd.Function`` whose backward is the
backward kernel; ``kernels.ops`` takes it on the card wherever autograd
tracks an input.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_Q = 512          # the kernel's score rows and B slab fit shared memory
HEADS_PER_BLOCK = 8  # csrc/ssd_chunk.cu's head subset (at most)
BWD_HEADS_PER_BLOCK = 16   # csrc/ssd_chunk_bwd.cu's head subset (at most)


def check_grouped(cum, b, c, xdt) -> None:
    """Raise on anything the kernel does not take: cum (Bz, NC, Q, H) f32
    contiguous; b, c (Bz, NC, Q, G, N) with N contiguous and G dividing H;
    xdt (Bz, NC, Q, H, P) contiguous; b, c, xdt of one dtype, f32 or bf16;
    all on one device; Q at most ``MAX_Q``."""
    if cum.dim() != 4 or min(cum.shape) < 1:
        raise ValueError(f"cum must be a non-empty (Bz, NC, Q, H) tensor, got "
                         f"shape {tuple(cum.shape)}")
    if cum.dtype != torch.float32:
        raise TypeError(f"cum dtype {cum.dtype}: expected float32")
    bz, nc, q, h = cum.shape
    if q > MAX_Q:
        raise ValueError(f"chunk Q={q} exceeds the kernel's {MAX_Q}")
    for name, t in (("b", b), ("c", c)):
        if t.dim() != 5 or tuple(t.shape[:3]) != (bz, nc, q) or \
                min(t.shape) < 1:
            raise ValueError(f"{name} shape {tuple(t.shape)}: expected "
                             f"({bz}, {nc}, {q}, G, N)")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along N")
    if b.shape != c.shape:
        raise ValueError(f"b shape {tuple(b.shape)} != c shape "
                         f"{tuple(c.shape)}")
    if h % b.shape[3]:
        raise ValueError(f"G={b.shape[3]} groups do not divide H={h} heads")
    if xdt.dim() != 5 or tuple(xdt.shape[:4]) != (bz, nc, q, h) or \
            xdt.shape[4] < 1:
        raise ValueError(f"xdt shape {tuple(xdt.shape)}: expected "
                         f"({bz}, {nc}, {q}, {h}, P)")
    for name, t in (("b", b), ("c", c), ("xdt", xdt)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {t.dtype}: expected float32 or "
                            f"bfloat16")
    if not b.dtype == c.dtype == xdt.dtype:
        raise TypeError(f"b, c, xdt dtypes differ: {b.dtype}, {c.dtype}, "
                        f"{xdt.dtype}")
    if not (cum.is_contiguous() and xdt.is_contiguous()):
        raise ValueError("ssd_intra_chunk_grouped: cum and xdt must be "
                         "contiguous")
    for t in (b, c, xdt):
        if t.device != cum.device:
            raise ValueError(f"ssd_intra_chunk inputs span devices "
                             f"{t.device} and {cum.device}")


def ssd_intra_chunk_grouped_plain(cum, b, c, xdt):
    """Plain-torch twin: ``(y (Bz, NC, Q, H, P) in xdt's dtype, state
    (Bz, NC, H, P, N) f32, chunk_decay (Bz, NC, H) f32)``, the reference's
    oracle in f32 with B and C broadcast over each group's heads."""
    check_grouped(cum, b, c, xdt)
    bz, nc, q, h = cum.shape
    g, n, p = b.shape[3], b.shape[4], xdt.shape[4]
    rep = h // g
    b32 = b.float().permute(0, 1, 3, 2, 4)[:, :, :, None]   # (.., G, 1, Q, N)
    c32 = c.float().permute(0, 1, 3, 2, 4)[:, :, :, None]
    x32 = xdt.float().permute(0, 1, 3, 2, 4).reshape(bz, nc, g, rep, q, p)
    cumh = cum.permute(0, 1, 3, 2).reshape(bz, nc, g, rep, q)
    decay = torch.exp(torch.clamp(cumh[..., :, None] - cumh[..., None, :],
                                  -60.0, 0.0))
    causal = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    scores = torch.where(causal, (c32 @ b32.transpose(-1, -2)) * decay, 0.0)
    y = (scores @ x32).reshape(bz, nc, h, q, p).permute(0, 1, 3, 2, 4)
    tail = torch.exp(torch.clamp(cumh[..., -1:] - cumh, -60.0, 0.0))
    state = x32.transpose(-1, -2) @ (b32 * tail[..., None])
    chunk_decay = torch.exp(torch.clamp(cum[:, :, -1], -60.0, 0.0))
    return (y.contiguous().to(xdt.dtype), state.reshape(bz, nc, h, p, n),
            chunk_decay)


def check_grouped_bwd(cum, b, c, xdt, dy, dstate, ddecay) -> None:
    """Raise on anything the backward kernel does not take: the forward's
    inputs as ``check_grouped`` takes them, dy (Bz, NC, Q, H, P) contiguous
    in xdt's dtype, dstate (Bz, NC, H, P, N) and ddecay (Bz, NC, H) f32
    contiguous, all on one device."""
    check_grouped(cum, b, c, xdt)
    bz, nc, q, h = cum.shape
    n, p = b.shape[4], xdt.shape[4]
    for name, t, shape, dtype in (
            ("dy", dy, (bz, nc, q, h, p), xdt.dtype),
            ("dstate", dstate, (bz, nc, h, p, n), torch.float32),
            ("ddecay", ddecay, (bz, nc, h), torch.float32)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}: expected "
                             f"{shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} dtype {t.dtype}: expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk_grouped backward: {name} "
                             f"must be contiguous")
        if t.device != cum.device:
            raise ValueError(f"ssd_intra_chunk inputs span devices "
                             f"{t.device} and {cum.device}")


def ssd_intra_chunk_grouped_bwd_plain(cum, b, c, xdt, dy, dstate, ddecay):
    """Plain-torch backward twin: the gradients ``(dcum (Bz, NC, Q, H) f32,
    db, dc (Bz, NC, Q, G, N), dxdt (Bz, NC, Q, H, P))`` of the grouped
    forward's outputs ``(y, state, chunk_decay)`` given their gradients
    ``(dy, dstate, ddecay)``; db, dc, dxdt come out in the inputs' dtype,
    every sum runs in f32. Per cell and head h of group g, with
    S = C_g B_g^T, L_ij = exp(clip(cum_i - cum_j, -60, 0)) [i >= j],
    M = S * L and tail_j = exp(clip(cum_{Q-1} - cum_j, -60, 0)):

        dM    = (dy xdt^T) [i >= j]
        dxdt  = M^T dy + (B_g * tail) dstate^T
        dS_h  = dM * L
        dC_g  = (sum_h dS_h) B_g
        dB_g  = (sum_h dS_h)^T C_g + sum_h tail * (xdt_h dstate_h)
        dcum_i = rowsum(dS * S)_i - colsum(dS * S)_i - r_i
                 + [i = Q-1] (sum_j r_j + ddecay chunk_decay)

    with r_j = tail_j sum_{p,n} xdt_jp B_jn dstate_pn. A term whose clip
    binds takes no gradient (the diagonal's and r_{Q-1}'s cancel and are
    left out). The heads of a group sum dS before the two products."""
    check_grouped_bwd(cum, b, c, xdt, dy, dstate, ddecay)
    bz, nc, q, h = cum.shape
    g, n, p = b.shape[3], b.shape[4], xdt.shape[4]
    rep = h // g
    b32 = b.float().permute(0, 1, 3, 2, 4)                  # (.., G, Q, N)
    c32 = c.float().permute(0, 1, 3, 2, 4)
    x32 = xdt.float().permute(0, 1, 3, 2, 4).reshape(bz, nc, g, rep, q, p)
    dy32 = dy.float().permute(0, 1, 3, 2, 4).reshape(bz, nc, g, rep, q, p)
    ds32 = dstate.reshape(bz, nc, g, rep, p, n)
    cumh = cum.permute(0, 1, 3, 2).reshape(bz, nc, g, rep, q)

    diff = cumh[..., :, None] - cumh[..., None, :]          # cum_i - cum_j
    causal = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    decay = torch.where(causal, torch.exp(torch.clamp(diff, -60.0, 0.0)),
                        0.0)
    live = (torch.ones_like(causal).tril(-1) & (diff >= -60.0)
            & (diff <= 0.0))
    s = (c32 @ b32.transpose(-1, -2))[:, :, :, None]        # (.., 1, Q, Q)
    m = s * decay
    dm = torch.where(causal, dy32 @ x32.transpose(-1, -2), 0.0)
    ds = dm * decay
    e = torch.where(live, ds * s, 0.0)

    tdiff = cumh[..., -1:] - cumh
    tail = torch.exp(torch.clamp(tdiff, -60.0, 0.0))        # (.., rep, Q)
    b_tail = b32[:, :, :, None] * tail[..., None]           # (.., rep, Q, N)
    dxdt = m.transpose(-1, -2) @ dy32 + b_tail @ ds32.transpose(-1, -2)
    xd = x32 @ ds32                                         # (.., rep, Q, N)
    ds_g = ds.sum(3)
    dc = ds_g @ b32
    db = ds_g.transpose(-1, -2) @ c32 + (tail[..., None] * xd).sum(3)
    r = torch.where((tdiff >= -60.0) & (tdiff <= 0.0),
                    tail * (xd * b32[:, :, :, None]).sum(-1), 0.0)
    r[..., -1] = 0.0                                        # cancels itself
    dcum = e.sum(-1) - e.sum(-2) - r
    last = cumh[..., -1]
    dcum[..., -1] += r.sum(-1) + torch.where(
        (last >= -60.0) & (last <= 0.0),
        ddecay.reshape(bz, nc, g, rep) * torch.exp(torch.clamp(last, -60.0,
                                                               0.0)), 0.0)
    return (dcum.reshape(bz, nc, h, q).permute(0, 1, 3, 2).contiguous(),
            db.permute(0, 1, 3, 2, 4).contiguous().to(b.dtype),
            dc.permute(0, 1, 3, 2, 4).contiguous().to(c.dtype),
            dxdt.reshape(bz, nc, h, q, p).permute(0, 1, 3, 2, 4).contiguous()
            .to(xdt.dtype))


def grouped_example(bz, nc, q, h, g, n, p, *, dtype=torch.float32, seed=0,
                    offset=None, device="cpu"):
    """Seeded grouped inputs for checking the kernels against their twins:
    cum (Bz, NC, Q, H) a decreasing cumulative log-decay (steps 0.05 +
    0.2 U[0, 1)), xdt (Bz, NC, Q, H, P) and B, C (Bz, NC, Q, G, N)
    standard normal in ``dtype``. B and C are contiguous, or with
    ``offset`` strided views of one (Bz, NC Q, offset + 2 G N) tensor, as
    ``ssd_chunked`` hands over the conv output's columns."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cum = -torch.cumsum(0.05 + 0.2 * torch.rand(
        (bz, nc, q, h), generator=gen, device=device), dim=2)
    xdt = torch.randn((bz, nc, q, h, p), generator=gen,
                      device=device).to(dtype)
    if offset is None:
        b, c = (torch.randn((bz, nc, q, g, n), generator=gen,
                            device=device).to(dtype) for _ in range(2))
    else:
        xbc = torch.randn((bz, nc * q, offset + 2 * g * n), generator=gen,
                          device=device).to(dtype)
        b = xbc[..., offset:offset + g * n].reshape(bz, nc, q, g, n)
        c = xbc[..., offset + g * n:].reshape(bz, nc, q, g, n)
    return cum, b, c, xdt


def grouped_bwd_example(bz, nc, q, h, g, n, p, *, steep=0.2,
                        dtype=torch.float32, seed=0, offset=None,
                        device="cpu"):
    """The backward's arguments for checking it against its twin:
    ``grouped_example``'s B, C and xdt, cum redrawn with log-decay steps
    0.05 + ``steep`` U[0, 1) (steep enough and the -60 clip binds), and
    the outputs' gradients: dy in ``dtype``, dstate and ddecay f32,
    standard normal."""
    _, b, c, xdt = grouped_example(bz, nc, q, h, g, n, p, dtype=dtype,
                                   seed=seed, offset=offset, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cum = -torch.cumsum(0.05 + steep * torch.rand(
        (bz, nc, q, h), generator=gen, device=device), dim=2)
    dy = torch.randn(xdt.shape, generator=gen, device=device).to(dtype)
    dstate = torch.randn((bz, nc, h, p, n), generator=gen, device=device)
    ddecay = torch.randn((bz, nc, h), generator=gen, device=device)
    return cum, b, c, xdt, dy, dstate, ddecay


def heads_per_block(rep: int, cap: int = HEADS_PER_BLOCK) -> int:
    """The kernel's head subset: the largest divisor of rep up to ``cap``
    (8, the forward's)."""
    return max(d for d in range(1, min(rep, cap) + 1) if rep % d == 0)


def bwd_heads_per_block(rep: int) -> int:
    """The backward's head subset, the pair and state blocks' heads: the
    largest divisor of rep up to 16."""
    return heads_per_block(rep, BWD_HEADS_PER_BLOCK)


def bwd_blocks(bz, nc, q, h, g, n, p) -> dict:
    """The backward's blocks per launch, as ``csrc/ssd_chunk_bwd.cu``
    lays them out over (cell, group) x roles, 64-row tiles: ``scores`` one
    per lower (query tile, key tile) pair; ``heads`` state blocks (head
    subset, key tile), pair blocks (head subset, pair) and dxdt blocks
    (head, key tile); ``reduce`` (row tile, N tile, dC or dB)."""
    rep = h // g
    hs = bwd_heads_per_block(rep)
    q_tiles, n_tiles = -(-q // 64), -(-n // 64)
    pairs = q_tiles * (q_tiles + 1) // 2
    cells = bz * nc * g
    state, pair = rep // hs * q_tiles, rep // hs * pairs
    dxdt = rep * q_tiles
    return {"heads_per_block": hs, "subsets": rep // hs,
            "scores": cells * pairs, "state": cells * state,
            "pair": cells * pair, "dxdt": cells * dxdt,
            "heads": cells * (state + pair + dxdt),
            "reduce": cells * q_tiles * n_tiles * 2}


def _lib():
    fn = build.library("ssd_chunk").repro_ssd_grouped
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 16 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _vec16(b, c, xdt) -> bool:
    """True when every tile row the kernel stages starts on 16 bytes."""
    sz = xdt.element_size()
    ptrs = [t.data_ptr() for t in (b, c, xdt)]
    strides = [s * sz for t in (b, c) for s in t.stride()[:4]]
    strides.append(xdt.shape[4] * sz)       # a head's row offset in xdt
    return all(v % 16 == 0 for v in ptrs + strides)


def _bwd_vec16(b, c, xdt, dy, dstate) -> bool:
    """The backward's staging variant, as ``repro_ssd_grouped_bwd`` picks
    it: True (16-byte cp.async) when every tile row it stages from B, C,
    xdt, dy and dstate starts on 16 bytes, else plain loads."""
    return (_vec16(b, c, xdt) and dy.data_ptr() % 16 == 0
            and dstate.data_ptr() % 16 == 0 and dstate.shape[4] * 4 % 16 == 0)


def ssd_intra_chunk_grouped_cuda(cum, b, c, xdt):
    """Launch the CUDA kernel: ``(y, state, chunk_decay)`` as the twin.
    Raises on a tensor off the GPU or a failed launch; never falls back."""
    global launches
    check_grouped(cum, b, c, xdt)
    if cum.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_grouped_cuda needs CUDA tensors, "
                         f"got {cum.device}")
    bz, nc, q, h = cum.shape
    g, n, p = b.shape[3], b.shape[4], xdt.shape[4]
    if bz * nc * g > 2**31 - 1:
        raise ValueError(f"Bz*NC*G={bz * nc * g} exceeds the kernel's grid")
    fn = _lib()
    dev = cum.device
    y = torch.empty((bz, nc, q, h, p), dtype=xdt.dtype, device=dev)
    state = torch.empty((bz, nc, h, p, n), dtype=torch.float32, device=dev)
    decay = torch.empty((bz, nc, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(cum.data_ptr(), b.data_ptr(), c.data_ptr(), xdt.data_ptr(),
                y.data_ptr(), state.data_ptr(), decay.data_ptr(), bz, nc, q,
                h, g, n, p, *b.stride()[:4], *c.stride()[:4],
                heads_per_block(h // g), _DTYPES[xdt.dtype],
                int(_vec16(b, c, xdt)), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return y, state, decay


def _bwd_lib():
    lib = build.library("ssd_chunk_bwd")
    fn = lib.repro_ssd_grouped_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 16 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.repro_ssd_bwd_workspace
    ws.argtypes = [ctypes.c_int64] * 8
    ws.restype = ctypes.c_int64
    return fn, ws


def ssd_intra_chunk_grouped_bwd_cuda(cum, b, c, xdt, dy, dstate, ddecay):
    """Launch the backward kernels (three launches, one count in
    ``bwd_launches``): ``(dcum, db, dc, dxdt)`` as
    ``ssd_intra_chunk_grouped_bwd_plain``, with db and dc contiguous in
    the views' shape. Raises on a tensor off the GPU or a failed launch;
    never falls back."""
    global bwd_launches
    check_grouped_bwd(cum, b, c, xdt, dy, dstate, ddecay)
    if cum.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_grouped_bwd_cuda needs CUDA "
                         f"tensors, got {cum.device}")
    bz, nc, q, h = cum.shape
    g, n, p = b.shape[3], b.shape[4], xdt.shape[4]
    hs = bwd_heads_per_block(h // g)
    fn, ws = _bwd_lib()
    nbytes = ws(bz, nc, q, h, g, n, p, hs)
    if nbytes <= 0:
        raise ValueError(f"ssd_intra_chunk backward: shape (Bz {bz}, NC "
                         f"{nc}, Q {q}, H {h}, G {g}, N {n}, P {p}) exceeds "
                         f"the kernel's grid")
    dev = cum.device
    work = torch.empty((nbytes // 4,), dtype=torch.float32, device=dev)
    dcum = torch.empty_like(cum)
    db = torch.empty(b.shape, dtype=b.dtype, device=dev)
    dc = torch.empty(c.shape, dtype=c.dtype, device=dev)
    dxdt = torch.empty_like(xdt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(cum.data_ptr(), b.data_ptr(), c.data_ptr(), xdt.data_ptr(),
                dy.data_ptr(), dstate.data_ptr(), ddecay.data_ptr(),
                dcum.data_ptr(), db.data_ptr(), dc.data_ptr(),
                dxdt.data_ptr(), work.data_ptr(), bz, nc, q, h, g, n, p,
                *b.stride()[:4], *c.stride()[:4], hs, _DTYPES[xdt.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk backward launch failed: CUDA "
                           f"error {rc}")
    bwd_launches += 1
    return dcum, db, dc, dxdt


class _SsdIntraChunk(torch.autograd.Function):
    """The kernel under autograd: the forward kernel saves its inputs (no
    Q x Q tensor is kept), the backward kernel recomputes S and the decays
    from them. ``ssd_chunked`` reads every chunk's state and decay but the
    last one's only through the final state, so that chunk's dstate and
    ddecay arrive as zeros in training."""

    @staticmethod
    def forward(ctx, cum, b, c, xdt):
        y, state, decay = ssd_intra_chunk_grouped_cuda(cum, b, c, xdt)
        ctx.save_for_backward(cum, b, c, xdt)
        return y, state, decay

    @staticmethod
    def backward(ctx, dy, dstate, ddecay):
        cum, b, c, xdt = ctx.saved_tensors
        return ssd_intra_chunk_grouped_bwd_cuda(
            cum, b, c, xdt, dy.contiguous(), dstate.contiguous(),
            ddecay.contiguous())


def ssd_intra_chunk_grouped_train(cum, b, c, xdt):
    """``ssd_intra_chunk_grouped_cuda`` differentiable in cum, b, c and
    xdt: the forward kernel, then, in the backward, the backward kernel
    (CUDA tensors only: each kernel's wrapper checks)."""
    return _SsdIntraChunk.apply(cum, b, c, xdt)


# --- the reference-shaped adapter: G cells of one head each --------------

def check_inputs(cum, b, c, xdt) -> None:
    """Raise on anything the reference-shaped entry does not take: cum
    (G, Q) f32; b, c (G, Q, N) and xdt (G, Q, P) of one dtype, f32 or
    bf16; all contiguous and on one device."""
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


def _as_grouped(cum, b, c, xdt):
    g, q = cum.shape
    return (cum.view(g, 1, q, 1), b.view(g, 1, q, 1, b.shape[2]),
            c.view(g, 1, q, 1, c.shape[2]), xdt.view(g, 1, q, 1, xdt.shape[2]))


def _as_reference(y, state, decay):
    g, _, q, _, p = y.shape
    n = state.shape[4]
    return (y.view(g, q, p), state.view(g, p, n).transpose(1, 2),
            decay.view(g))


def ssd_intra_chunk_plain(cum, b, c, xdt):
    """The reference-shaped twin: ``(y (G, Q, P) in xdt's dtype, state
    (G, N, P) f32, chunk_decay (G,) f32)``."""
    check_inputs(cum, b, c, xdt)
    return _as_reference(*ssd_intra_chunk_grouped_plain(
        *_as_grouped(cum, b, c, xdt)))


def ssd_intra_chunk_cuda(cum, b, c, xdt):
    """The reference-shaped kernel call: ``(y, state, chunk_decay)`` as
    ``ssd_intra_chunk_plain``; one launch of the grouped kernel."""
    check_inputs(cum, b, c, xdt)
    return _as_reference(*ssd_intra_chunk_grouped_cuda(
        *_as_grouped(cum, b, c, xdt)))


def ssd_intra_chunk_train(cum, b, c, xdt):
    """The reference-shaped entry differentiable in its inputs: the
    grouped train Function with H = G = 1."""
    check_inputs(cum, b, c, xdt)
    return _as_reference(*ssd_intra_chunk_grouped_train(
        *_as_grouped(cum, b, c, xdt)))
