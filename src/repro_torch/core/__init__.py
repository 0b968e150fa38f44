"""PAOTA's core modules, torch form: the AirComp channel (aircomp), the
semi-async scheduler (scheduler), the eq.-25 factors (power_control), the
water-filling P2 solve (boxqp) and the aggregation rule (aggregation)."""
from repro_torch.core.aircomp import VARSIGMA_MIN, ChannelConfig  # noqa: F401
from repro_torch.core.scheduler import SchedulerConfig  # noqa: F401
