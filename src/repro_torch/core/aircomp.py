"""Over-the-air computation channel model (Section II-C), torch form.

Port of ``repro.core.aircomp``: Rayleigh fading, the instantaneous power
cap (7) and the eq.-8 normalizer clamp. The superposition itself is the
sweep-2 kernel (``repro_torch.kernels.aircomp_sum``), reached through
``repro_torch.core.aggregation``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.scheduler import TAG_CHANNEL, round_tag_generator
from repro_torch.device import f32

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
