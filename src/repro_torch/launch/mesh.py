"""Meshes of named axes over ``torch.distributed`` ranks, and the rank
launcher.

Port of ``repro.launch.mesh``. A ``Mesh`` lays the ranks of the process
group out row-major over named axes (``("data",)``, ``("pod", "data")`` or
``("pod", "data", "tp")``) and holds, for every subset of its axes, the
``dist.new_group`` subgroup of the ranks that share the other axes'
coordinates: the group a reduction "over those axes" runs on. Every rank
builds every group once, in the same order, as ``new_group`` requires.

``init_ranks`` starts one rank's process group; ``run_ranks`` (or
``start_ranks``, which returns at once) spawns a world of ranks on one
host (``spawn``, never ``fork``: the parent may hold a CUDA context), runs
a function on each and returns what each returned.
A rank that fails, or a world that outlives ``timeout_s``, kills the other
ranks and raises with the failed ranks' tracebacks. The backend is the
caller's: ``"nccl"`` when each rank owns ``cuda:LOCAL_RANK``, ``"gloo"`` on
the CPU and for ranks that share one card (NCCL refuses two ranks on one
device; gloo reduces CUDA tensors with ``all_reduce`` and ``broadcast``
only).
Nothing here picks a backend or a device by itself.

Nothing runs at import time.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import queue
import socket
import sys
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """Named axes over the process group's ranks, row-major: rank r sits at
    ``np.unravel_index(r, extents)``. ``axis_names`` and ``shape`` (a dict
    of extents) are what the sharding rules read, as the reference's."""

    def __init__(self, axes: Sequence[Tuple[str, int]]):
        self.axis_names = tuple(a for a, _ in axes)
        self.shape: Dict[str, int] = {a: int(n) for a, n in axes}
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} repeat a name")
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.size != world:
            raise ValueError(
                f"mesh {self.shape} holds {self.size} ranks but the process "
                f"group has {world}; start the ranks first (init_ranks, "
                f"run_ranks, or python -m torch.distributed.run)")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords: Dict[str, int] = {}
        rest = self.rank
        for a in reversed(self.axis_names):
            rest, self.coords[a] = divmod(rest, self.shape[a])
        self._groups: Dict[Tuple[str, ...], object] = {}
        for n in range(1, len(self.axis_names) + 1):
            for subset in itertools.combinations(self.axis_names, n):
                self._groups[subset] = self._new_groups(subset)

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _new_groups(self, subset):
        """The group of this rank over ``subset``, after every rank has
        made every group of the subset in the same order. None where the
        subset spans one rank."""
        if self.extent(subset) == 1:
            return None
        others = [a for a in self.axis_names if a not in subset]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            ranks = [self._rank_of({**base, **dict(zip(subset, c))})
                     for c in itertools.product(*(range(self.shape[a])
                                                  for a in subset))]
            group = dist.new_group(ranks=ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or names) in mesh order; raise on a stranger."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        bad = [a for a in names if a not in self.shape]
        if bad:
            raise ValueError(f"axes {bad} are not mesh axes "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def extent(self, axes) -> int:
        """The number of ranks a reduction over ``axes`` spans."""
        return math.prod(self.shape[a] for a in self.axes(axes))

    def group(self, axes):
        """This rank's process group over ``axes`` (None: one rank)."""
        axes = self.axes(axes)
        return self._groups[axes] if axes else None

    def index(self, axes) -> int:
        """This rank's row-major linear coordinate over ``axes``: the
        reference's ``axis_index`` flattening."""
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def make_client_mesh(n: Optional[int] = None) -> Mesh:
    """Every rank a client shard: one ``("data",)`` axis over the world
    (``n`` must equal it)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh((("data", world if n is None else n),))


def make_pod_mesh(*, pods: int = 2, data: int = 1, tp: int = 1) -> Mesh:
    """``("pod", "data")`` client mesh: ``pods`` aggregation groups of
    ``data`` client shards; ``tp > 1`` appends an intra-client ``"tp"``
    axis (each client's model storage spans ``tp`` ranks)."""
    if tp == 1:
        return Mesh((("pod", pods), ("data", data)))
    return Mesh((("pod", pods), ("data", data), ("tp", tp)))


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's client axes: "pod" and "data", in mesh order."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def client_axes_for(cfg, mesh) -> Tuple[str, ...]:
    """The reference's PAOTA client-axis policy
    (``repro.launch.mesh.client_axes_for``): the giant MoE archs take the
    "pod" axis; small archs whose attention heads do not divide the
    "model" axis flatten clients over it too; everything else takes the
    data axes."""
    if cfg.name.startswith(("llama4", "mixtral")):
        return ("pod",) if "pod" in mesh.axis_names else ()
    msize = mesh.shape.get("model", 1)
    heads_bad = cfg.num_heads and cfg.num_heads % msize != 0
    small = cfg.name.startswith(("smollm", "internvl2", "minicpm"))
    if heads_bad and small:
        return data_axes(mesh) + ("model",)
    return data_axes(mesh)


def init_ranks(rank: int, world: int, *, backend: str, init_method: str,
               timeout_s: float = 600.0) -> None:
    """Join this process to the world as ``rank`` of ``world``."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend={backend!r} (expected 'gloo' or 'nccl')")
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))


def free_init_method() -> str:
    """A ``tcp://127.0.0.1:<port>`` address on a port that was free."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _rank_main(rank, world, fn, backend, device, init_method, timeout_s,
               threads, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_ranks(rank, world, backend=backend, init_method=init_method,
                   timeout_s=timeout_s)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = fn(rank, world, dev, *args)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        if leaked:
            raise RuntimeError(f"rank {rank} imported {leaked[:5]}: a rank "
                               f"worker must not load JAX or the reference")
        results.put((rank, True, out))
    except BaseException:           # reported, then the process exits
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankGroup:
    """A world of spawned ranks running one function (``start_ranks``);
    ``wait`` collects their results."""

    def __init__(self, fn, world, *, backend, device, init_method,
                 timeout_s, threads, args):
        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self._results = ctx.Queue()
        init_method = init_method or free_init_method()
        self._procs = [
            ctx.Process(target=_rank_main, name=f"rank{r}",
                        args=(r, world, fn, backend, device, init_method,
                              timeout_s, threads, args, self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + timeout_s

    def _failures(self, rank, out, grace_s: float = 5.0) -> str:
        """The report of a failed world: every rank that fails within
        ``grace_s`` of the first, with its traceback, and every rank that
        died without one. A rank's failure takes down its peers'
        collectives, and the first report to arrive need not be the
        cause."""
        failed = {rank: out}
        end = time.monotonic() + grace_s
        while len(failed) < self.world and time.monotonic() < end:
            try:
                r, fine, msg = self._results.get(timeout=0.5)
            except queue.Empty:
                continue
            if not fine:
                failed[r] = msg
        dead = [r for r, p in enumerate(self._procs)
                if p.exitcode not in (None, 0) and r not in failed]
        lines = [f"rank {r} of {self.world} failed:\n{failed[r]}"
                 for r in sorted(failed)]
        lines += [f"rank {r} exited with code {self._procs[r].exitcode} "
                  f"without a report" for r in dead]
        return "\n".join(lines)

    def wait(self) -> list:
        """The ranks' results in rank order. A rank that raised or died,
        or a world still running ``timeout_s`` seconds after its start,
        kills every rank and raises (RuntimeError with every failed rank's
        traceback, ``_failures``, or TimeoutError)."""
        world, procs = self.world, self._procs
        got: Dict[int, object] = {}
        ok = False
        try:
            while len(got) < world:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"ranks {missing} of {world} still "
                                       f"ran after {self.timeout_s} s")
                try:
                    rank, fine, out = self._results.get(
                        timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} before reporting")
                    continue
                if not fine:
                    raise RuntimeError(self._failures(rank, out))
                got[rank] = out
            ok = True
        finally:
            for p in procs:
                if ok:
                    p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            self._results.close()
        return [got[r] for r in range(world)]


def start_ranks(fn: Callable, world: int, *, backend: str, device: str,
                init_method: Optional[str] = None, timeout_s: float = 120.0,
                threads: Optional[int] = None,
                args: tuple = ()) -> RankGroup:
    """Spawn ``world`` ranks of one process group, each running ``fn(rank,
    world, device, *args)``, and return at once; ``RankGroup.wait`` gives
    the results. ``fn`` must be importable from a module that imports no
    JAX (a spawned child imports it by name, and a rank that has loaded
    JAX or the reference fails); ``args`` and the results are pickled.
    ``threads`` sets each rank's torch CPU threads (ranks on one host
    share its cores)."""
    return RankGroup(fn, world, backend=backend, device=device,
                     init_method=init_method, timeout_s=timeout_s,
                     threads=threads, args=args)


def run_ranks(fn: Callable, world: int, *, backend: str, device: str,
              init_method: Optional[str] = None, timeout_s: float = 120.0,
              threads: Optional[int] = None, args: tuple = ()) -> list:
    """``start_ranks(...).wait()``: the ranks' results in rank order."""
    return start_ranks(fn, world, backend=backend, device=device,
                       init_method=init_method, timeout_s=timeout_s,
                       threads=threads, args=args).wait()
