"""Over-the-air computation channel model (Section II-C), torch form.

Port of ``repro.core.aircomp``: Rayleigh fading, the instantaneous power
cap (7), the eq.-8 normalizer clamp, and ``aircomp_aggregate``, eqs. 6 + 8
with the AWGN realization handed in (``use_kernel`` routes it through the
``aircomp_sum`` kernel, ``repro_torch.kernels.ops.aircomp_sum``). The
fused round's superposition is the sweep-2 kernel, reached through
``repro_torch.core.aggregation``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.scheduler import TAG_CHANNEL, round_tag_generator
from repro_torch.device import f32
from repro_torch.kernels.ops import aircomp_sum

# Smallest meaningful eq.-8 normalizer sum_k b_k p_k: the division clamp and
# the zero-uploader threshold (at or below it nothing superposed this
# period, and the round must hold the global model).
VARSIGMA_MIN = 1e-12


def dbm_per_hz_to_watts(n0_dbm_hz: float) -> float:
    """-174 dBm/Hz -> Watts/Hz."""
    return 10.0 ** ((n0_dbm_hz - 30.0) / 10.0)


@dataclass(frozen=True)
class ChannelConfig:
    """Section IV-A settings by default."""
    bandwidth_hz: float = 20e6
    n0_dbm_hz: float = -174.0
    p_max_watts: float = 15.0
    rayleigh_scale: float = 1.0

    @property
    def sigma_n2(self) -> float:
        """Noise power sigma_n^2 = B * N0 (Watts)."""
        return self.bandwidth_hz * dbm_per_hz_to_watts(self.n0_dbm_hz)

    @property
    def sigma_n(self) -> float:
        """sqrt(sigma_n^2), rounded through f32 as the reference's
        ``float(jnp.sqrt(...))`` is."""
        return f32(math.sqrt(f32(self.sigma_n2)))


def rayleigh_from_uniform(u: torch.Tensor, chan: ChannelConfig):
    """|h| = scale * sqrt(-2 log u) for u ~ U(1e-6, 1)."""
    return f32(chan.rayleigh_scale) * torch.sqrt(-2.0 * torch.log(u))


def sample_channel_gains(base_seed: int, round_idx: int, k: int,
                         chan: ChannelConfig, device) -> torch.Tensor:
    """|h_k| ~ Rayleigh(scale) for round ``round_idx``, keyed on
    (seed, round, TAG_CHANNEL): the magnitude of CN(0, 2 scale^2)."""
    gen = round_tag_generator(base_seed, round_idx, TAG_CHANNEL, device)
    u = torch.rand((k,), generator=gen, device=device, dtype=torch.float32)
    u = f32(1e-6) + f32(1.0 - 1e-6) * u
    return rayleigh_from_uniform(u, chan)


def effective_power_cap(w_norm2, h_abs, p_max: float, eps: float = 1e-12):
    """Power constraint (7): p_k <= |h_k| sqrt(P_max / ||w_k||^2)."""
    num = torch.full_like(w_norm2, f32(p_max))
    return h_abs * torch.sqrt(num / torch.clamp_min(w_norm2, f32(eps)))


def aircomp_aggregate(stacked: torch.Tensor, powers: torch.Tensor,
                      mask: torch.Tensor, noise: torch.Tensor,
                      use_kernel: bool = False):
    """Eqs. (6)+(8): the (K, D) payload -> (D,) normalized aggregate, with
    ``noise`` the (D,) f32 AWGN realization already scaled by sigma_n.
    Returns (aggregate, varsigma = max(sum_k b_k p_k, VARSIGMA_MIN))."""
    bp = powers * mask
    varsigma = torch.clamp_min(bp.sum(), f32(VARSIGMA_MIN))
    if use_kernel:
        agg = aircomp_sum(stacked, bp, noise)
    else:
        agg = (bp.to(stacked.dtype) @ stacked + noise.to(stacked.dtype)) \
            / varsigma.to(stacked.dtype)
    return agg, varsigma


def aggregation_weights(powers, mask):
    """alpha_k = b_k p_k / sum_i b_i p_i (eq. 8)."""
    bp = powers * mask
    return bp / torch.clamp_min(bp.sum(), f32(VARSIGMA_MIN))


def equivalent_noise_var(sigma_n2: float, powers, mask, d: int):
    """E||n~||^2 = d sigma_n^2 / (sum_k b_k p_k)^2 (term (e)'s basis)."""
    s = torch.clamp_min((powers * mask).sum(), f32(VARSIGMA_MIN))
    return d * sigma_n2 / (s * s)
