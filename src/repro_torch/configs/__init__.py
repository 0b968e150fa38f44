"""Registry of the architectures the port runs, as ``repro.configs`` names
them: every arch id of the reference.

``get_config("smollm-135m")`` returns the published config and
``get_reduced`` its smoke-test variant, for the ``dense`` family
(smollm-135m, olmo-1b, minicpm-2b, granite-3-8b), the ``moe`` family
(mixtral-8x22b, llama4-maverick-400b-a17b), the ``ssm`` family
(mamba2-370m), the ``hybrid`` family (zamba2-7b), the ``vlm`` family
(internvl2-1b) and the ``audio`` family (hubert-xlarge). An id the
reference does not know raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(name: str):
    key = name.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[key])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
