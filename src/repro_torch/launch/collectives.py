"""The sharded round's reductions across ranks, and their log.

Where the reference calls ``psum`` / ``pmin`` / ``pmax`` over mesh axes
inside ``shard_map``, the port's sharded round calls a ``Reducer``: each
``sum`` / ``min`` / ``max`` is one ``dist.all_reduce`` on the mesh's group
over the named axes, and nothing else. An axis subset that spans one rank
reduces nothing and is not called; ``reducer=None`` in the round is the
single-device program.

Every call is logged (op, axes, numel, bytes, tag). The log is the
port's form of the reference's collective-count contract
(``repro.launch.collectives``, which counts all-reduces in the compiled
HLO): a round of the flat or TP path shows exactly one all-reduce of
d_total + 1 floats, the grouped path one cross-pod one a window, and
every other call is small.

gloo reduces CUDA tensors (sum, min and max) in place, on the card's
stream, and so does NCCL: nothing is staged through the host here
(``chip_smoke.py``'s ``sharded`` phase probes gloo on the card).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist


class Call(NamedTuple):
    op: str                 # "sum" | "min" | "max"
    axes: tuple             # mesh axes reduced over
    numel: int
    nbytes: int
    tag: str                # what the round reduces ("superpose", ...)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class Reducer:
    """All-reduces over subsets of ``mesh``'s axes; ``axes`` is the default
    subset (all of them when None)."""

    def __init__(self, mesh, axes=None, *, log: Optional[List[Call]] = None):
        self.mesh = mesh
        self.axes = mesh.axes(mesh.axis_names if axes is None else axes)
        self.log: List[Call] = [] if log is None else log

    def over(self, axes) -> Optional["Reducer"]:
        """A reducer over ``axes`` sharing this one's log, or None where
        the subset spans one rank (the single-device form)."""
        axes = self.mesh.axes(axes)
        if not axes or self.mesh.extent(axes) == 1:
            return None
        return Reducer(self.mesh, axes, log=self.log)

    def sum(self, t: torch.Tensor, axes=None, tag: str = "") -> torch.Tensor:
        return self._reduce("sum", t, axes, tag)

    def min(self, t: torch.Tensor, axes=None, tag: str = "") -> torch.Tensor:
        return self._reduce("min", t, axes, tag)

    def max(self, t: torch.Tensor, axes=None, tag: str = "") -> torch.Tensor:
        return self._reduce("max", t, axes, tag)

    def _reduce(self, op, t, axes, tag):
        """The reduction of ``t`` (reduced in place when it is contiguous,
        and returned)."""
        axes = self.axes if axes is None else self.mesh.axes(axes)
        if not axes or self.mesh.extent(axes) == 1:
            return t
        t = t.contiguous()
        dist.all_reduce(t, op=_OPS[op], group=self.mesh.group(axes))
        self.log.append(Call(op, axes, t.numel(),
                             t.numel() * t.element_size(), tag))
        return t

    def mark(self) -> int:
        """The log's length, to count the calls made after it."""
        return len(self.log)

    def calls_since(self, mark: int) -> List[Call]:
        return self.log[mark:]
