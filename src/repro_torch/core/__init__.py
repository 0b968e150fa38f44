"""PAOTA's core modules, torch form: the AirComp channel (aircomp), the
semi-async scheduler and the scenario simulator (scheduler), payload
compression (compress), the eq.-25 factors and P2 (power_control),
the P2 solvers (boxqp, dinkelbach, milp) and the aggregation rule
(aggregation)."""
from repro_torch.core.aircomp import VARSIGMA_MIN, ChannelConfig  # noqa: F401
from repro_torch.core.scheduler import (ScenarioConfig,  # noqa: F401
                                        SchedulerConfig, SemiAsyncScheduler)
