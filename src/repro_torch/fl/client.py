"""Edge-device client description, torch form.

Port of ``repro.fl.client.FLClient`` as the batched engine consumes it: a
client is its dataset plus its local-SGD hyperparameters (eq. 3: M
minibatch steps from the received global model). The steps themselves run
for all K clients at once in ``repro_torch.fl.engine.BatchedEngine``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.data.pipeline import ClientData


class FLClient:
    def __init__(self, data: ClientData, loss_fn: Callable,
                 batch_size: int = 32, lr: float = 0.05,
                 local_steps: int = 5):
        self.data = data
        self.loss_fn = loss_fn
        self.batch_size = batch_size
        self.lr = lr
        self.local_steps = local_steps
