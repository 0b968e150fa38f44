"""Named runs of the sharded PAOTA round on a world of ranks.

``run_cases(rank, world, device, spec)`` is a rank function for
``repro_torch.launch.mesh.run_ranks``: it builds each case of
``spec["cases"]`` in turn on every rank and returns, per case, what the
caller checks (per-step globals, history rows, the reducer's calls, the
launch counters, wall times). The CPU tests and ``chip_smoke.py`` drive
the sharded round through it, so one group of ranks runs every case.
It imports no JAX: a spawned rank imports it by name.

``spec``: ``feds`` (name -> {"x", "y"} arrays or {"x_path", "y_path"}
``.npy`` files, and ``parts``, one index array a client), ``params`` (a
numpy params dict) and ``cases``. A case is a dict with ``name`` and
``kind`` ("paota", "waterfill", "refusals", "harness", "allreduce" or
"probe"); a
"paota" case names its ``fed``, ``mesh`` ((axis, extent) pairs),
``rounds``, ``step`` (rounds an ``advance``), ``sched`` / ``chan`` /
``cfg`` keyword dicts, ``knobs`` for ``ShardedPAOTA`` (a ``faults`` dict
becomes a ``FaultConfig``), ``client`` hyperparameters and optional
``draws`` (the arrays of an ``ArrayDraws``; default ``CounterDraws``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.tree import tree_leaves

__all__ = ["run_cases"]


def _federation(fed, client):
    from repro_torch.data.pipeline import ClientData
    from repro_torch.fl import FLClient
    from repro_torch.models.mlp import mlp_loss
    if "x_path" in fed:
        x = np.load(fed["x_path"], mmap_mode="r")
        y = np.load(fed["y_path"], mmap_mode="r")
    else:
        x, y = fed["x"], fed["y"]
    hp = dict(batch_size=32, lr=0.1, local_steps=5, **(client or {}))
    return [FLClient(ClientData(np.asarray(x[p]), np.asarray(y[p]), k, 0),
                     mlp_loss, **hp) for k, p in enumerate(fed["parts"])]


def _params(params, device):
    if isinstance(params, dict):
        return {k: _params(v, device) for k, v in params.items()}
    return torch.as_tensor(np.asarray(params), dtype=torch.float32,
                           device=device)


def _counters():
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    return {"round_stats": rs.launches, "aircomp_partial": ac.partial_launches,
            "superpose_normalize": ac.launches}


def _zero_counters():
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import round_stats as rs
    rs.launches = ac.partial_launches = ac.launches = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _driver(case, spec, device, mesh):
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.core.scheduler import FaultConfig
    from repro_torch.fl import ArrayDraws, PAOTAConfig
    from repro_torch.fl.sharded import ShardedPAOTA
    clients = _federation(spec["feds"][case["fed"]], case.get("client"))
    knobs = dict(case.get("knobs", {}))
    if "faults" in knobs:
        knobs["faults"] = FaultConfig(**knobs["faults"])
    draws = None
    if case.get("draws") is not None:
        draws = ArrayDraws(**case["draws"], device=device)
    return ShardedPAOTA(
        _params(spec["params"], device), clients,
        ChannelConfig(**case.get("chan", {})),
        SchedulerConfig(n_clients=len(clients), **case.get("sched", {})),
        PAOTAConfig(**case.get("cfg", {})), mesh=mesh, device=device,
        draws=draws, **knobs)


def _paota(case, spec, device):
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(case["mesh"])
    drv = _driver(case, spec, device, mesh)
    step = case.get("step", 1)
    out = {"d": drv.d, "k_local": drv.k_local, "k_pad": drv.k_pad,
           "offset": drv.offset, "coords": mesh.coords, "globals": [],
           "rows": [], "calls": [], "seconds": [], "restarted": [],
           "leaves": len(tree_leaves(drv._init_global))}
    _sync(device)
    _zero_counters()
    for _ in range(case["rounds"] // step):
        mark = drv.reducer.mark()
        t0 = time.perf_counter()
        out["rows"] += drv.advance(step)
        _sync(device)
        out["seconds"].append(time.perf_counter() - t0)
        out["calls"].append([tuple(c) for c in drv.reducer.calls_since(mark)])
        out["globals"].append(drv.global_vec.copy())
        carry = drv._carry
        out["restarted"].append(int((carry.model_round == carry.t).sum()))
    out["launches"] = _counters()
    return out


def _waterfill(case, spec, device):
    """``waterfill_beta`` on this rank's rows of the full-K inputs, over a
    reducer of the mesh's axes: (the rank's beta rows, objective)."""
    from repro_torch.core.boxqp import waterfill_beta
    from repro_torch.launch.collectives import Reducer
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(case["mesh"])
    k = len(case["rho"])
    k_local = k // mesh.size
    lo = mesh.index(mesh.axis_names) * k_local

    def rows(a):
        return torch.as_tensor(np.asarray(a, np.float32)[lo:lo + k_local],
                               device=device)
    red = Reducer(mesh)
    beta, obj = waterfill_beta(rows(case["rho"]), rows(case["theta"]),
                               rows(case["p_max"]), rows(case["b"]),
                               case["c1"], case["c0"], reducer=red)
    return {"beta": beta.cpu().numpy(), "objective": float(obj),
            "calls": [tuple(c) for c in red.log]}


def _refusals(case, spec, device):
    """The messages of the sharded round's refusals, by knob."""
    from repro_torch.launch.mesh import Mesh
    got = {}
    for name, mesh_axes, knobs in case["tries"]:
        try:
            _driver(dict(case, knobs=knobs), spec, device, Mesh(mesh_axes))
        except (NotImplementedError, ValueError) as err:
            got[name] = f"{type(err).__name__}: {err}"
        else:
            got[name] = None
    return got


def _harness(case, spec, device):
    """``bench.common.run_algorithm`` with the sharded engine."""
    from repro_torch.bench.common import (BenchSetting, build_world,
                                          run_algorithm)
    s = BenchSetting(**case["setting"])
    clients, params, data = build_world(s)
    return run_algorithm("paota", s, clients, params, data, device=device)


def _allreduce(case, spec, device):
    """``paota_allreduce`` and ``exact_average`` of one payload a rank
    (``case["payloads"][rank]``, a numpy params dict) over every rank."""
    import torch.distributed as dist
    from repro_torch.core.aggregation import exact_average, paota_allreduce
    from repro_torch.launch.collectives import Reducer
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.tree import tree_map
    red = Reducer(make_client_mesh())
    r = dist.get_rank()
    payload = _params(case["payloads"][r], device)
    noise = _params(case["noise"], device)
    agg = paota_allreduce(payload, torch.tensor(case["powers"][r],
                                                device=device),
                          torch.tensor(case["ready"][r], device=device),
                          red, noise)
    avg = exact_average(payload, torch.tensor(case["weights"][r],
                                              device=device), red)
    return {"paota": tree_map(lambda t: t.cpu().numpy(), agg),
            "exact": tree_map(lambda t: t.cpu().numpy(), avg),
            "calls": len(red.log)}


def _probe(case, spec, device):
    """One all-reduce of each op on a small tensor on ``device``, over the
    whole world: what the backend gives back for [1 + rank, 5 - rank]."""
    import torch.distributed as dist
    out = {}
    for op in ("SUM", "MIN", "MAX"):
        t = torch.tensor([1.0 + dist.get_rank(), 5.0 - dist.get_rank()],
                         device=device)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        out[op] = t.tolist()
    return out


_KINDS = {"paota": _paota, "waterfill": _waterfill, "refusals": _refusals,
          "harness": _harness, "probe": _probe, "allreduce": _allreduce}


def run_cases(rank, world, device, spec):
    """Every case of ``spec`` in turn on this rank; name -> result."""
    return {case["name"]: _KINDS[case.get("kind", "paota")](case, spec,
                                                             device)
            for case in spec["cases"]}
