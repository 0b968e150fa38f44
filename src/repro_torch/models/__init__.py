"""The paper's MLP and the LM zoo's ssm family (mamba2-370m), torch form."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_decode_state,
    init_model,
    loss_fn,
    param_count,
    active_param_count,
)
