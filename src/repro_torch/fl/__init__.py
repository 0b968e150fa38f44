"""Federated learning, torch form: clients, the batched engine, the
PAOTA configuration and the fused on-device round."""
from repro_torch.fl.client import FLClient  # noqa: F401
from repro_torch.fl.engine import BatchedEngine  # noqa: F401
from repro_torch.fl.fused import FusedPAOTA  # noqa: F401
from repro_torch.fl.runtime import ArrayDraws, CounterDraws  # noqa: F401
from repro_torch.fl.server import PAOTAConfig  # noqa: F401
