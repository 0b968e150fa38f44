"""The paper's own experiment model (Section IV-A): an MLP with two hidden
layers of 10 nodes for 10-class 28x28 digit classification, trained by the
port's FL runtime (``repro_torch.fl``) on the non-IID federation.

A copy of ``repro.configs.mlp_mnist``. Not part of the transformer zoo;
build it with ``repro_torch.models.mlp.init_mlp_params``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class MLPConfig:
    d_in: int = 784          # 28x28
    hidden: int = 10         # "two hidden layers with 10 nodes"
    n_layers: int = 2
    n_classes: int = 10
    source: str = "PAOTA paper Sec. IV-A (MLP on MNIST)"


CONFIG = MLPConfig()
