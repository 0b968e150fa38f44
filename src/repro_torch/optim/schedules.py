"""Learning-rate schedules, torch form of ``repro.optim.schedules``: each
maps an int step tensor to an f32 scalar tensor. WSD (warmup-stable-decay)
is the MiniCPM recipe [arXiv:2404.06395] selected by the minicpm-2b
config's training setup."""
from __future__ import annotations

import math

import torch

from repro_torch.device import f32


def constant(lr: float):
    return lambda step: torch.tensor(f32(lr))


def cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        s = step.float()
        warm = f32(peak) * s / f32(max(warmup, 1))
        t = torch.clamp((s - f32(warmup)) / f32(max(total - warmup, 1)),
                        0.0, 1.0)
        cos = f32(floor) + f32(0.5 * (peak - floor)) * (
            1 + torch.cos(f32(math.pi) * t))
        return torch.where(s < warmup, warm, cos)
    return fn


def wsd(peak: float, warmup: int, stable: int, decay: int,
        floor_frac: float = 0.1):
    """MiniCPM WSD: linear warmup -> flat stable phase -> exponential-style
    decay to floor_frac*peak over `decay` steps."""
    floor = peak * floor_frac

    def fn(step):
        s = step.float()
        warm = f32(peak) * s / f32(max(warmup, 1))
        t = torch.clamp((s - f32(warmup + stable)) / f32(max(decay, 1)),
                        0.0, 1.0)
        dec = f32(peak) * torch.pow(torch.tensor(f32(floor / peak)), t)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable,
                                       torch.tensor(f32(peak)), dec))
    return fn
