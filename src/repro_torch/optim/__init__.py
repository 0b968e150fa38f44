"""Functional optimizers and learning-rate schedules, torch form."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, apply_updates, clip_by_global_norm, global_norm, sgd)
from repro_torch.optim.schedules import constant, cosine, wsd  # noqa: F401
