"""Registry of the architectures the port runs, as ``repro.configs`` names
them.

``get_config("smollm-135m")`` returns the published config and
``get_reduced`` its smoke-test variant, for the ``dense`` family
(smollm-135m, olmo-1b, minicpm-2b, granite-3-8b), the ``moe`` family
(mixtral-8x22b, llama4-maverick-400b-a17b), the ``ssm`` family
(mamba2-370m) and the ``hybrid`` family (zamba2-7b). The reference's other
arch ids (internvl2-1b, hubert-xlarge) are known but not ported yet:
asking for one raises ``NotImplementedError`` naming it; an id the
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
}

# the reference's other arch ids (repro/configs/__init__.py), not ported
_UNPORTED = ("internvl2-1b", "hubert-xlarge")

ARCH_IDS: List[str] = list(_MODULES)


def _module(name: str):
    key = name.replace("_", "-")
    if key in _UNPORTED:
        raise NotImplementedError(
            f"arch {key!r} is not ported yet; the port runs {ARCH_IDS}")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[key])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
