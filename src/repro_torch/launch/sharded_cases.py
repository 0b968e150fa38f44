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
``kind`` ("paota", "resume", "restore", "state_plane", "waterfill",
"refusals", "harness", "allreduce" or "probe"); a
"paota" case names its ``fed``, ``mesh`` ((axis, extent) pairs),
``rounds``, ``step`` (rounds an ``advance``), ``sched`` / ``chan`` /
``cfg`` keyword dicts, ``knobs`` for ``ShardedPAOTA`` (a ``faults`` dict
becomes a ``FaultConfig``), ``client`` hyperparameters and optional
``draws`` (the arrays of an ``ArrayDraws``; default ``CounterDraws``);
``state`` keeps the rank's (K,) state plane and slot maps every step, and
``twin_rerun`` runs the case again with the kernels' plain twins patched
in where ``ops`` routes to the kernels (on the card: the kernel run's
oracle). A "resume" case runs ``rounds`` and, in a second driver, stops
at ``kill`` and saves to ``path``; a "restore" case (in fresh ranks)
restores ``path`` and runs to ``rounds``. A "state_plane" case is the
million-client cohort harness on the sharded runtime.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.tree import tree_leaves

__all__ = ["run_cases"]

# the carry fields a "state" case keeps every step
STATE = ("slot_client", "slot_live", "ready", "model_round", "busy_lat")


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
    from repro_torch.kernels import gather_superpose as gs
    from repro_torch.kernels import round_stats as rs
    return {"round_stats": rs.launches, "aircomp_partial": ac.partial_launches,
            "superpose_normalize": ac.launches,
            "gather_superpose": gs.launches,
            "gather_superpose_partial": gs.partial_launches}


def _zero_counters():
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import gather_superpose as gs
    from repro_torch.kernels import round_stats as rs
    rs.launches = ac.partial_launches = ac.launches = 0
    gs.launches = gs.partial_launches = 0


@contextlib.contextmanager
def plain_twins():
    """Every kernel wrapper the sharded round reaches replaced by its plain
    twin, so ``ops`` routes a CUDA tensor to the twin (on the CPU the twins
    run anyway); restored on exit."""
    from repro_torch.kernels import aircomp_sum as ac
    from repro_torch.kernels import gather_superpose as gs
    from repro_torch.kernels import round_stats as rs
    swaps = [(ac, "aircomp_partial"), (ac, "superpose_normalize"),
             (gs, "gather_superpose"), (gs, "gather_superpose_partial"),
             (rs, "round_stats")]
    saved = [(mod, name, getattr(mod, f"{name}_cuda")) for mod, name in swaps]
    try:
        for mod, name in swaps:
            setattr(mod, f"{name}_cuda", getattr(mod, f"{name}_plain"))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, f"{name}_cuda", fn)


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


def _run(drv, case, device, out):
    """``case["rounds"]`` rounds of ``drv`` in steps of ``case["step"]``,
    per step: the history rows, the reducer's calls, the wall seconds, the
    global, the clients restarted and (``case["state"]``) the state."""
    step = case.get("step", 1)
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
        if case.get("state"):
            out["state"].append({f: getattr(carry, f).cpu().numpy()
                                 for f in STATE})
    return out


def _paota(case, spec, device):
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(case["mesh"])
    drv = _driver(case, spec, device, mesh)
    out = {"d": drv.d, "k_local": drv.k_local, "k_pad": drv.k_pad,
           "offset": drv.offset, "coords": mesh.coords, "globals": [],
           "rows": [], "calls": [], "seconds": [], "restarted": [],
           "state": [], "m_local": drv.m_local,
           "compress_s": drv.compress_s,
           "leaves": len(tree_leaves(drv._init_global))}
    _sync(device)
    _zero_counters()
    _run(drv, case, device, out)
    out["launches"] = _counters()
    if case.get("twin_rerun"):
        del drv
        with plain_twins():
            twin = _run(_driver(case, spec, device, mesh), case, device,
                        {"globals": [], "rows": [], "calls": [],
                         "seconds": [], "restarted": [], "state": []})
        out["twin_globals"], out["twin_rows"] = twin["globals"], twin["rows"]
    return out


def _resume(case, spec, device):
    """The uninterrupted run, then a second driver killed at ``kill``
    rounds after saving ``path``: the full run's globals and history,
    the file's bytes and the save's seconds."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(case["mesh"])
    full = _driver(case, spec, device, mesh)
    full.advance(case["rounds"])
    part = _driver(case, spec, device, mesh)
    part.advance(case["kill"])
    _sync(device)
    t0 = time.perf_counter()
    part.save_checkpoint(case["path"])
    save_s = time.perf_counter() - t0
    return {"global": full.global_vec.copy(), "history": full.history,
            "file_bytes": os.path.getsize(case["path"]), "save_s": save_s}


def _restore(case, spec, device):
    """A fresh driver restored from ``path`` and run to ``rounds``."""
    from repro_torch.launch.mesh import Mesh
    drv = _driver(case, spec, device, Mesh(case["mesh"]))
    t0 = time.perf_counter()
    step = drv.restore_checkpoint(case["path"])
    _sync(device)
    restore_s = time.perf_counter() - t0
    drv.advance(case["rounds"] - step)
    return {"step": step, "global": drv.global_vec.copy(),
            "history": drv.history, "restore_s": restore_s}


def _state_plane(case, spec, device):
    """The million-client cohort harness (``benchmarks/cohort_round_bench
    .py`` ``_synth_scan``) on the sharded runtime: ``k`` clients over the
    mesh's ranks, ``m`` slots (m / ranks a rank), fabricated updates
    g + 1e-3 N(0, 1), each rank its rows of one full (m, d) draw a round,
    the counter latency / channel / priority draws and the availability
    cycle + dropout scenario over all k, randmask ``ratio``, ``slot_dtype``
    slots, no error feedback; ``rounds`` rounds after the round-0 carry.
    Returns ms a round, the launches, the uploaders a round, the global's
    norm and whether it is finite, and the reducer's calls a round."""
    from repro_torch.core import ChannelConfig, ScenarioConfig
    from repro_torch.core.power_control import p2_constants
    from repro_torch.core.scheduler import round_tag_generator
    from repro_torch.fl.runtime import (CounterDraws, RoundCfg, RoundStreams,
                                        init_cohort_carry, scan_rounds)
    from repro_torch.fl.sharded import ShardDraws
    from repro_torch.launch.collectives import Reducer
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(case["mesh"])
    red = Reducer(mesh)
    k, m, d = case["k"], case["m"], case["d"]
    n = mesh.size
    s = round(d * case["ratio"])
    k_local, m_local = k // n, m // n
    shard = mesh.index(mesh.axis_names)
    chan = ChannelConfig(**case.get("chan", {}))
    sc = ScenarioConfig(availability="cycle", avail_period=4,
                        avail_duty=0.5, dropout_prob=0.05)
    full = CounterDraws(0, 0, device, k=k, d=d, lat_lo=5.0, lat_hi=15.0,
                        chan=chan, n_samples=np.ones(1, np.int64),
                        local_steps=1, batch_size=1, scenario=sc, m=m, s=s)
    draws = ShardDraws(full, shard * k_local, k_local, k, shard=shard,
                       m_local=m_local)
    c1, c0 = p2_constants(10.0, 0.05, k, d, chan.sigma_n2)
    rcfg = RoundCfg(omega=3.0, c1=c1, c0=c0, p_max_watts=chan.p_max_watts,
                    delta_t=8.0, transmit_delta=True, cohort_size=m,
                    compress="randmask", compress_s=s,
                    slot_dtype=case["slot_dtype"], error_feedback=False)

    def fan(g, r, ids):
        # tag 12: clear of the scheduler's draw tags (0-10)
        gen = round_tag_generator(0, r, 12, device)
        z = torch.randn((m, d), generator=gen, device=device)
        lo = shard * m_local
        return g[None, :] + 1e-3 * z[lo:lo + m_local]

    streams = RoundStreams(
        local_train=None, latencies=draws.latencies, channel=draws.channel,
        noise=full.noise, scenario=draws.scenario_masks, cohort_train=fan,
        sched_priority=draws.sched_priority,
        compress_mask=draws.compress_mask,
        quant_uniform=(draws.quant_uniform
                       if case["slot_dtype"] == "int8" else None))
    with torch.no_grad():
        carry = init_cohort_carry(torch.zeros((d,), device=device),
                                  streams=streams, k=k_local, m=m_local,
                                  keep_pending=False, rcfg=rcfg)
        _sync(device)
        _zero_counters()
        mark = red.mark()
        t0 = time.perf_counter()
        carry, outs = scan_rounds(carry, case["rounds"], rcfg=rcfg,
                                  streams=streams, reducer=red)
        _sync(device)
        t1 = time.perf_counter()
    calls = [tuple(c) for c in red.calls_since(mark)]
    g = carry.global_vec
    return {"ms_per_round": (t1 - t0) * 1e3 / case["rounds"],
            "launches": _counters(), "compress_s": s, "k_local": k_local,
            "m_local": m_local,
            "n_participants": outs["n_participants"].cpu().tolist(),
            "finite": bool(torch.isfinite(g).all()),
            "global_norm": float(g.norm()), "global": g.cpu().numpy(),
            "calls_per_round": len(calls) / case["rounds"],
            "model_sized": sum(1 for c in calls if c[2] == d + 1)}


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


_KINDS = {"paota": _paota, "resume": _resume, "restore": _restore,
          "state_plane": _state_plane, "waterfill": _waterfill,
          "refusals": _refusals, "harness": _harness, "probe": _probe,
          "allreduce": _allreduce}


def run_cases(rank, world, device, spec):
    """Every case of ``spec`` in turn on this rank; name -> result."""
    return {case["name"]: _KINDS[case.get("kind", "paota")](case, spec,
                                                             device)
            for case in spec["cases"]}
