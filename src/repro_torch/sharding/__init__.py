"""Placement rules of the sharded round: per-dim mesh-axis assignments for
client-stacked params and batches (``rules``) and the intra-client TP
topology (``tp``)."""
from repro_torch.sharding.rules import (batch_specs,  # noqa: F401
                                        decode_state_specs, param_specs,
                                        stack_client_specs)
