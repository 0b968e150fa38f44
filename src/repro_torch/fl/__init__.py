"""Federated learning, torch form: clients, the batched engine, the PAOTA
configuration, the host-path server, the fused on-device round and its
sharded form over ranks, the synchronous baselines, and the evaluation
helpers."""
from repro_torch.fl.baselines import (COTAFServer, LocalSGDServer,  # noqa: F401
                                      SyncConfig)
from repro_torch.fl.client import FLClient  # noqa: F401
from repro_torch.fl.engine import BatchedEngine, make_engine  # noqa: F401
from repro_torch.fl.fused import FusedPAOTA  # noqa: F401
from repro_torch.fl.metrics import (evaluate, time_to_accuracy,  # noqa: F401
                                    write_csv)
from repro_torch.fl.runtime import ArrayDraws, CounterDraws  # noqa: F401
from repro_torch.fl.server import PAOTAConfig, PAOTAServer  # noqa: F401
from repro_torch.fl.sharded import ShardedPAOTA  # noqa: F401
