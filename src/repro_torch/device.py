"""Device resolution for the port's entry points.

``device=None`` means the GPU. A CUDA request on a machine without one is an
error: the port never moves a run to the CPU behind the caller's back.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} resolves to {dev}, but torch.cuda is not "
            f"available; pass device='cpu' to run the plain-torch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def full_f32_matmul() -> None:
    """Turn TF32 off for matmuls and cuDNN: the reference contracts in full
    f32, and TF32 keeps only ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float. Scalar constants
    pass through this before they meet an f32 tensor, so the op rounds like
    the reference's weak-typed f32 scalar whatever precision torch computes
    the scalar op in."""
    return float(np.float32(x))
