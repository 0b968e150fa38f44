"""PAOTA server configuration (Algorithm 1), torch form.

Port of ``repro.fl.server.PAOTAConfig``. The host-path ``PAOTAServer`` has
no port yet; the fused round (``repro_torch.fl.fused.FusedPAOTA``) reads
this configuration.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PAOTAConfig:
    omega: float = 3.0            # staleness constant Omega (Sec. IV-A)
    solver: str = "waterfill"     # P2 solver; the fused round water-fills
    smooth_l: float = 10.0        # L (Sec. IV-A)
    eps_bound: float = 0.05       # epsilon (Assumption 3)
    use_kernel: bool = False      # host-path aggregation kernel (no port yet)
    engine: str = "batched"       # local-training engine
    transmit: str = "model"       # "model" (eq. 6: clients transmit w_k) |
                                  # "delta" (clients transmit dw_k)
    seed: int = 0
