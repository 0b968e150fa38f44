"""The paper's MLP and the LM zoo's dense, moe, ssm and hybrid families
(smollm-135m, olmo-1b, minicpm-2b, granite-3-8b; mixtral-8x22b,
llama4-maverick-400b-a17b; mamba2-370m; zamba2-7b), torch form."""
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
