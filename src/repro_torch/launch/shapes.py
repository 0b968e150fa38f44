"""The reference's assigned input shapes, torch form (plain data): a copy
of ``repro.launch.shapes``' ``InputShape``, ``SHAPES`` and
``shape_config``.

  train_4k       seq_len=  4,096  global_batch= 256  (training)
  prefill_32k    seq_len= 32,768  global_batch=  32  (inference-prefill)
  decode_32k     seq_len= 32,768  global_batch= 128  (inference-decode)
  long_500k      seq_len=524,288  global_batch=   1  (long-context-decode)

The reference's ``input_specs`` (abstract inputs for lowering) belongs to
its XLA tooling and is not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

from repro_torch.models.config import ModelConfig

# the SWA width applied to full-attention archs at long_500k
LONG_CONTEXT_WINDOW = 4096


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config: at long_500k a full-attention arch outside the
    ssm / hybrid families takes the sliding-window variant."""
    if (shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid")
            and cfg.sliding_window is None):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg
