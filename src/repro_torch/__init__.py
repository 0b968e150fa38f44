"""PyTorch port of the PAOTA reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core``, ``data``, ``models``, ``fl``, ``kernels``, ``launch``,
``checkpoint``) so each module's counterpart is easy to find. It imports
torch, numpy and the standard library only — never ``jax``, nothing under
``repro`` and not ``ml_dtypes``.

Entry points take ``device=None``, which means ``"cuda"``; without a GPU they
raise instead of falling back to the CPU. Tests pass ``device="cpu"``, where
every kernel wrapper takes its plain-torch twin.
"""
from repro_torch.device import full_f32_matmul, resolve_device

__all__ = ["full_f32_matmul", "resolve_device"]
