"""PAOTA's core modules, torch form: the AirComp channel (aircomp), the
semi-async scheduler and the scenario simulator (scheduler), payload
compression (compress), the eq.-25 factors and P2 (power_control),
the P2 solvers (boxqp, dinkelbach, milp), the aggregation rule
(aggregation) and the Theorem-1 bound calculators (convergence)."""
from repro_torch.core.aircomp import VARSIGMA_MIN, ChannelConfig  # noqa: F401
from repro_torch.core.scheduler import (ScenarioConfig,  # noqa: F401
                                        SchedulerConfig, SemiAsyncScheduler)
from repro_torch.core.convergence import (BoundConstants,  # noqa: F401
                                          bound_trajectory, contraction_A,
                                          gap_G)
from repro_torch.core.dinkelbach import solve_p2  # noqa: F401
from repro_torch.core.power_control import P2Problem, build_p2  # noqa: F401
