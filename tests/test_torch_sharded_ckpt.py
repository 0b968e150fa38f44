"""Checkpoints of the port's sharded carry (``ShardedPAOTA.save_checkpoint``
/ ``restore_checkpoint`` over 4 gloo ranks on the CPU):

* kill at round 2 of 4, restore in fresh ranks, and the rest bit-identical
  to the uninterrupted run (tests/test_fault_round.py:237-290), on every
  layout: flat K = 10 padded to 12 with faults and screening, grouped
  N = 2 with pod 1 dark across the kill, the compressed topk int8 cohort
  and TP 2 x 2 (pytree);
* the file is the one the reference's ``ShardedPAOTA`` writes of its
  global carry: its keys, dtypes and shapes are those of the reference's
  ``FusedPAOTA`` file of the same configuration (``held`` as (n_pods,
  d + 1) after ``deltas`` in the grouped carry);
* a flat, unpadded sharded file loads with the reference's
  ``repro.checkpoint.io.load_checkpoint`` into its ``FusedPAOTA``'s carry
  template (``restore_checkpoint``), and that run continues within the
  fused tolerance (rtol 1e-4 / atol 1e-5) of the port's.

A first group of 4 spawned ranks runs each layout whole and again to the
kill, saving; a second, fresh group restores each file and finishes.
"""
import json
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.partition import partition_noniid  # noqa: E402
from repro.data.synthetic import make_mnist_like  # noqa: E402
from repro.models.mlp import init_mlp_params  # noqa: E402
from repro_torch.launch.mesh import start_ranks  # noqa: E402
from repro_torch.launch.sharded_cases import run_cases  # noqa: E402
from test_torch_cohort import reference, reference_draws  # noqa: E402

R, KILL = 4, 2
RANKS = 4
RANKS_TIMEOUT_S = 150
RATIO = 1 / 16
FAULTS = dict(nan_frac=0.25, byzantine_frac=0.25, deep_fade_frac=0.2)
COMPRESSED = dict(cohort_size=4, compress="topk", compress_ratio=RATIO,
                  slot_dtype="int8")


def _index(path):
    with np.load(path, allow_pickle=False) as z:
        idx = json.loads(str(z["__index__"]))
    return list(zip(idx["keys"], idx["dtypes"], map(tuple, idx["shapes"])))


def _cases(draws8):
    base = dict(rounds=R, kill=KILL, sched=dict(seed=1),
                mesh=[("data", RANKS)], fed="k8",
                cfg=dict(transmit="model"))
    return [
        dict(base, name="flat_faults", fed="k10",
             knobs=dict(faults=FAULTS, screen=True)),
        dict(base, name="grouped_blackout", mesh=[("pod", 2), ("data", 2)],
             knobs=dict(group_period=2, screen=True, faults=dict(
                 nan_frac=0.2, pod_blackout=(1,), blackout_start=1,
                 blackout_stop=3))),
        dict(base, name="compressed_int8", cfg=dict(transmit="delta"),
             knobs=COMPRESSED),
        dict(base, name="tp2x2", mesh=[("data", 2), ("tp", 2)],
             knobs=dict(params_mode="pytree")),
        dict(base, name="flat_reference_draws", draws=draws8),
    ]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Save in one group of ranks and restore in a fresh one, the
    reference's files and its continued run meanwhile; returns (saving
    ranks' results, restoring ranks', the reference's, wall seconds)."""
    t0 = time.perf_counter()
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    x, y, _, _ = make_mnist_like(n_train=2000, n_test=10)
    data8 = (x, y, partition_noniid(y, n_clients=8, seed=0))
    data10 = (x, y, partition_noniid(y, n_clients=10, seed=0))
    draws8 = reference_draws(reference(data8, "model", k=8), R)
    cases = _cases(draws8)
    for case in cases:
        case["path"] = str(tmp / f"{case['name']}.npz")
    spec = {"feds": {"k8": {"x": x, "y": y, "parts": data8[2]},
                     "k10": {"x": x, "y": y, "parts": data10[2]}},
            "params": jax.tree_util.tree_map(
                np.asarray, init_mlp_params(jax.random.PRNGKey(0))),
            "cases": [dict(c, kind="resume") for c in cases]}
    ranks = start_ranks(run_cases, RANKS, backend="gloo", device="cpu",
                        timeout_s=RANKS_TIMEOUT_S, threads=1, args=(spec,))
    # the reference's files of the same configurations, unsharded
    want = {}
    for name, kw in (("flat", dict(transmit="model")),
                     ("pytree", dict(transmit="model",
                                     params_mode="pytree")),
                     ("compressed", dict(transmit="delta", **COMPRESSED))):
        ref = reference(data8, k=8, **kw)
        ref.advance(KILL)
        path = str(tmp / f"reference_{name}.npz")
        ref.save_checkpoint(path)
        want[name] = _index(path)
    saved = ranks.wait()
    spec["cases"] = [dict(c, kind="restore") for c in cases]
    fresh = start_ranks(run_cases, RANKS, backend="gloo", device="cpu",
                        timeout_s=RANKS_TIMEOUT_S, threads=1, args=(spec,))
    # the reference continues the port's flat file on its own draws
    ref = reference(data8, "model", k=8)
    step = ref.restore_checkpoint(str(tmp / "flat_reference_draws.npz"))
    rows = ref.advance(R - step)
    want["continued"] = (step, np.asarray(ref.global_vec).copy(), rows)
    restored = fresh.wait()
    seconds = time.perf_counter() - t0
    print(f"\nsharded checkpoint world: 2 x 4 gloo ranks + reference in "
          f"{seconds:.1f} s")
    return saved, restored, want, tmp, seconds


NAMES = ["flat_faults", "grouped_blackout", "compressed_int8", "tp2x2",
         "flat_reference_draws"]


@pytest.mark.parametrize("name", NAMES)
def test_resume_in_fresh_ranks_is_bit_exact(world, name):
    saved, restored, _, _, _ = world
    for a, b in zip(saved, restored):
        full, res = a[name], b[name]
        assert res["step"] == KILL
        np.testing.assert_array_equal(res["global"], full["global"])
        assert res["history"] == full["history"]
        assert len(res["history"]) == R
    assert any(r["n_participants"] > 0 for r in saved[0][name]["history"])


def test_faults_and_blackout_cross_the_kill(world):
    """The layouts' knobs are live across the kill: rows were screened,
    and pod 1's blackout [1, 3) spans round 2."""
    saved, _, _, _, _ = world
    hist = saved[0]["flat_faults"]["history"]
    assert sum(r["n_screened"] for r in hist) > 0
    hist = saved[0]["grouped_blackout"]["history"]
    assert any(r["n_participants"] > 0 for r in hist[KILL:])


@pytest.mark.parametrize("name,ref", [("flat_reference_draws", "flat"),
                                      ("tp2x2", "pytree"),
                                      ("compressed_int8", "compressed")])
def test_file_layout_is_the_references(world, name, ref):
    """K = 8 over 4 shards needs no phantoms, so the sharded file's global
    carry has the reference's single-device layout: equal keys, dtypes
    and shapes (TP leaves whole, the slot planes (m, ...) in shard order,
    the parked residuals (K, s))."""
    _, _, want, tmp, _ = world
    assert _index(str(tmp / f"{name}.npz")) == want[ref]


def test_grouped_file_holds_one_partial_a_pod(world):
    _, _, want, tmp, _ = world
    got = _index(str(tmp / "grouped_blackout.npz"))
    flat = want["flat"]
    at = [k for k, _, _ in flat].index(".deltas") + 1
    d = flat[[k for k, _, _ in flat].index(".global_vec")][2][0]
    assert got == flat[:at] + [(".held", "float32", (2, d + 1))] + flat[at:]


def test_padded_file_keeps_the_phantom_rows(world):
    _, _, _, tmp, _ = world
    shapes = {k: s for k, _, s in _index(str(tmp / "flat_faults.npz"))}
    assert shapes[".ready"] == (12,)
    assert shapes[".pending"][0] == 12


def test_reference_continues_the_ports_sharded_file(world):
    """The reference's FusedPAOTA restores the port's flat sharded file
    (its load_checkpoint against its own carry template) and its rounds 2
    and 3 land within the fused tolerance of the port's uninterrupted
    sharded run, with the same uploaders."""
    saved, _, want, _, _ = world
    step, glob, rows = want["continued"]
    assert step == KILL
    full = saved[0]["flat_reference_draws"]
    np.testing.assert_allclose(glob, full["global"], rtol=1e-4, atol=1e-5)
    assert [r["n_participants"] for r in rows] == [
        r["n_participants"] for r in full["history"][KILL:]]


def test_file_bytes_and_times_are_reported(world):
    saved, restored, _, _, seconds = world
    for name in NAMES:
        assert saved[0][name]["file_bytes"] > 0
        assert saved[0][name]["save_s"] >= 0.0
        assert restored[0][name]["restore_s"] >= 0.0
    assert seconds < 240
