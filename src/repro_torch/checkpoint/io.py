"""npz checkpoints in the reference's layout (``repro.checkpoint.io``), so a
file either package writes, the other restores.

A tree (nested dicts, dataclasses such as ``RoundCarry``, lists and tuples
of tensors, numpy arrays or Python numbers) is flattened in JAX's
tree_flatten order: dict keys sorted, dataclass fields in declaration
order, None skipped. Each leaf is stored as its raw bytes (a flat uint8
array ``arr_<i>``), and a JSON ``__index__`` records every leaf's path key
(JAX's key string: ``.field`` for a dataclass field, the key for a dict,
joined by ``/``), dtype name and shape, with ``step`` and ``extra``. Raw
bytes keep every dtype bit for bit (bf16 included, read back through
``torch.frombuffer(...).view(torch.bfloat16)``). The file is written to a
temporary name in the target directory and renamed over the target, so a
reader never sees a partial file.

``load_checkpoint`` restores against a template tree of the same layout,
whose leaves give only the expected dtype; a leaf-count or dtype mismatch
between file and template raises, never a silent cast. Leaves come back
as CPU tensors.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

# dtype names as numpy (and the reference, through ml_dtypes) print them
_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
           torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_BY_NAME = {name: dt for dt, name in _DTYPES.items()}


def _flatten(tree, prefix: str = ""):
    """(key, leaf) pairs in leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [("." + f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, value in items:
        out.extend(_flatten(value, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _DTYPES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    extra: dict | None = None) -> None:
    flat = _flatten(tree)
    arrays, dtypes, shapes = {}, [], []
    for i, (_, leaf) in enumerate(flat):
        t = _as_tensor(leaf)
        dtypes.append(_DTYPES[t.dtype])
        shapes.append(list(t.shape))
        arrays[f"arr_{i}"] = t.reshape(-1).view(torch.uint8).numpy()
    index = {"keys": [k for k, _ in flat], "dtypes": dtypes,
             "shapes": shapes, "step": step, "extra": extra or {}}
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    # the .npz suffix keeps np.savez writing this very file (it appends
    # .npz to any other name)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=folder)
    os.close(fd)
    try:
        np.savez(tmp, __index__=json.dumps(index), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _from_bytes(raw: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    dtype = _BY_NAME[dtype_name]
    if raw.size == 0:
        return torch.empty(shape, dtype=dtype)
    buf = torch.frombuffer(bytearray(raw.tobytes()), dtype=torch.uint8)
    return buf.view(dtype).reshape(shape)


def load_checkpoint(path: str, template: Any):
    """Returns (tree, step, extra), the tree in ``template``'s structure
    with CPU tensors for leaves."""
    with np.load(path, allow_pickle=False) as z:
        index = json.loads(str(z["__index__"]))
        leaves_t = _flatten(template)
        if len(index["keys"]) != len(leaves_t):
            raise ValueError(
                f"checkpoint {path!r} holds {len(index['keys'])} leaves but "
                f"the template flattens to {len(leaves_t)} — the carry "
                "layout changed (different cohort/compress/grouped planes?)")
        restored = []
        for i, (_, leaf) in enumerate(leaves_t):
            have, want = index["dtypes"][i], _dtype_name(leaf)
            if have != want:
                raise ValueError(
                    f"checkpoint leaf {index['keys'][i]!r} is {have} but the "
                    f"template expects {want} — refusing a silent cast")
            restored.append(_from_bytes(z[f"arr_{i}"], have,
                                        index["shapes"][i]))
    return (_unflatten(template, iter(restored)), index["step"],
            index["extra"])
