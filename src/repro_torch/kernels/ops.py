"""The round's kernel seam: dispatch by the tensors' device, and nothing else.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain-torch twin. There is no environment switch and
no fallback from a failed launch to the twin.
"""
from __future__ import annotations

from repro_torch.kernels import aircomp_sum, round_stats as _rs


def _route(device, what: str) -> bool:
    """True for the kernel, False for the twin; raise elsewhere."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or twin for device {device}")


def round_stats(deltas, g, payload=None):
    """Fused eq.-25 stats over the raveled (K, D) plane in one sweep:
    ``(dots, dn2, pn2 | None, gn2)`` — (K,) f32 vectors and an f32
    scalar."""
    fn = (_rs.round_stats_cuda if _route(deltas.device, "round_stats")
          else _rs.round_stats_plain)
    stats, gn2 = fn(deltas, g, payload)
    pn2 = None if payload is None else stats[:, 2]
    return stats[:, 0], stats[:, 1], pn2, gn2


def superpose_normalize(stacked, powers, mask, noise, vs_min: float = 1e-12):
    """Fused eqs. (6)+(8) for the raveled (K, D) payload:
    ``(agg (D,) f32, raw varsigma f32 scalar)``."""
    fn = (aircomp_sum.superpose_normalize_cuda
          if _route(stacked.device, "superpose_normalize")
          else aircomp_sum.superpose_normalize_plain)
    return fn(stacked, powers, mask, noise, vs_min=vs_min)
