"""The port stands alone: no file of it imports JAX or the reference
package, importing it loads no JAX, and its entry points refuse to run on
the CPU unless asked to."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core.scheduler import FaultConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_reference(path):
    """Nor ``ml_dtypes``: the card's machine has only numpy, scipy, einops,
    pytest and hypothesis beside torch (bf16 checkpoint planes go through
    torch's own views). Nor the reference's harness, ``benchmarks`` and
    ``examples``: the port keeps its own copies (``repro_torch.bench``,
    ``repro_torch.launch``)."""
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes",
                           "benchmarks", "examples"), (
            f"{path.relative_to(ROOT)} imports {mod}")


def test_importing_the_port_loads_no_jax():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
            "                                    'benchmarks', 'examples'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for mod in ("fl.fused", "fl.server", "fl.baselines", "fl.metrics",
                "core.dinkelbach", "core.milp", "core.compress",
                "kernels.ops", "kernels.cosine_sim",
                "kernels.gather_superpose", "launch.fl_train",
                "kernels.ssd_chunk", "kernels.swa_attention", "configs",
                "configs.mamba2_370m", "models.config", "models.layers",
                "models.ssm", "models.transformer", "launch.steps",
                "launch.serve", "checkpoint.io", "tree", "core.convergence",
                "configs.mlp_mnist", "launch.quickstart", "bench.common",
                "bench.timing", "bench.bound", "bench.fig3", "bench.fig4",
                "bench.table1", "bench.ablation", "bench.kernels_bench",
                "bench.fl_engine_bench", "bench.fused_round_bench",
                "bench.round_perf_bench", "bench.diff", "bench.run"):
        assert f"repro_torch.{mod}" in names


def _tiny_federation():
    from repro_torch.data.pipeline import build_federation
    from repro_torch.fl import FLClient
    from repro_torch.models.mlp import mlp_loss
    rng = np.random.default_rng(0)
    x = rng.random((40, 784)).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    parts = [np.arange(0, 20), np.arange(20, 40)]
    return [FLClient(d, mlp_loss, batch_size=4, lr=0.1, local_steps=1)
            for d in build_federation(x, y, parts)]


def _server(**kw):
    from repro_torch.core import ChannelConfig, SchedulerConfig
    from repro_torch.fl import FusedPAOTA, PAOTAConfig
    from repro_torch.models.mlp import init_mlp_params
    cfg = kw.pop("cfg", PAOTAConfig())
    return FusedPAOTA(init_mlp_params(0), _tiny_federation(),
                      ChannelConfig(), SchedulerConfig(n_clients=2), cfg,
                      **kw)


def test_default_device_is_the_gpu_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _server()
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.resolve_device(None)
    assert _server(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("call", ["mlp_params_from_jax",
                                  "solve_p2_waterfill_jnp"])
def test_carry_across_and_p2_default_to_the_gpu(monkeypatch, call):
    """The MLP's weight carry-across and the f32 P2 solve resolve
    ``device=None`` to the card like every other entry point: without one
    they raise with resolve_device's message, and run when asked for the
    CPU."""
    from repro_torch.core.dinkelbach import solve_p2
    from repro_torch.core.power_control import build_p2
    from repro_torch.models.mlp import params_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if call == "mlp_params_from_jax":
        params = {"l1": {"w": np.ones((2, 3), np.float32),
                         "b": np.zeros(3, np.float32)}}

        def run(**kw):
            return params_from_jax(params, **kw)["l1"]["w"]
    else:
        rng = np.random.default_rng(0)
        prob = build_p2(rng.random(4), rng.random(4), 15.0 * rng.random(4),
                        np.ones(4), smooth_l=10.0, eps_bound=0.05,
                        model_dim=8070, sigma_n2=1e-13)

        def run(**kw):
            return solve_p2(prob, "waterfill_jnp", **kw).beta
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        run()
    assert np.isfinite(np.asarray(run(device="cpu"))).all()


# knobs whose branch runs only with a partner knob set
_PARTNERS = {"screen_max_norm": {"screen": True},
             "checkpoint_every": {"checkpoint_dir": "ckpt"}}


@pytest.mark.parametrize("knob,value", [
    ("params_mode", "pytree"), ("pending_dtype", "bfloat16"),
    ("screen_max_norm", 1.0), ("checkpoint_dir", "ckpt"),
    ("faults", FaultConfig(nan_frac=0.1)), ("screen", True),
    ("divergence_factor", 2.0), ("checkpoint_every", 5)])
def test_unported_branches_are_refused_by_name(knob, value, tmp_path):
    """The eight knobs the port once refused as unported now select their
    branch of the round: each is accepted and runs 2 rounds on the CPU
    (``faults`` a FaultConfig, which the reference takes; the checkpoint
    directory under ``tmp_path``)."""
    kw = {knob: value, **_PARTNERS.get(knob, {})}
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    drv = _server(device="cpu", **kw)
    rows = drv.advance(2)
    assert [r["round"] for r in rows] == [0, 1]
    assert np.isfinite(drv.global_vec).all()
    assert all(set(r) >= {"n_screened", "rolled_back"} for r in rows)


@pytest.mark.parametrize("kw,error,match", [
    (dict(params_mode="tree"), ValueError, "params_mode"),
    (dict(pending_dtype="float16"), ValueError, "pending_dtype"),
    (dict(faults=object()), ValueError, "FaultConfig"),
    (dict(faults="pod_blackout"), NotImplementedError, "grouped sharded"),
    (dict(screen_max_norm=1.0), ValueError, "screen=True"),
    (dict(checkpoint_every=2), ValueError, "checkpoint_dir"),
    (dict(divergence_factor=-1.0), ValueError, "divergence_factor"),
    (dict(params_mode="pytree", cohort_size=1, compress="topk",
          cfg="delta"), NotImplementedError, "params_mode='raveled'")],
    ids=["params_mode", "pending_dtype", "faults", "pod_blackout",
         "screen_max_norm", "checkpoint_every", "divergence_factor",
         "compress_pytree"])
def test_reference_refusals_keep_their_messages(kw, error, match):
    """Values the reference's FusedPAOTA refuses, refused with its
    messages; a pod blackout needs the grouped sharded driver."""
    from repro_torch.fl import PAOTAConfig
    if kw.get("faults") == "pod_blackout":
        kw["faults"] = FaultConfig(nan_frac=0.1, pod_blackout=(0,),
                                   blackout_start=1, blackout_stop=3)
    if kw.pop("cfg", None):
        kw["cfg"] = PAOTAConfig(transmit="delta")
    with pytest.raises(error, match=match):
        _server(device="cpu", **kw)


def test_off_values_of_unported_knobs_are_accepted():
    """Every knob at its off value is the plain round, row for row and bit
    for bit."""
    plain = _server(device="cpu")
    drv = _server(device="cpu", params_mode="raveled", cohort_size=0,
                  compress=None, screen=False, checkpoint_every=0,
                  faults=FaultConfig(), divergence_factor=0.0,
                  pending_dtype="float32", screen_max_norm=0.0,
                  checkpoint_dir=None)
    assert drv.advance(2)[-1]["round"] == 1
    assert drv.history == plain.advance(2)
    np.testing.assert_array_equal(drv.global_vec, plain.global_vec)


def test_bad_configurations_raise():
    from repro_torch.fl import PAOTAConfig
    with pytest.raises(TypeError, match="unexpected"):
        _server(device="cpu", donate=False)
    with pytest.raises(ValueError, match="use_kernel"):
        _server(device="cpu", cfg=PAOTAConfig(use_kernel=True))
    with pytest.raises(ValueError, match="solver"):
        _server(device="cpu", cfg=PAOTAConfig(solver="milp"))
    with pytest.raises(ValueError, match="transmit"):
        _server(device="cpu", cfg=PAOTAConfig(transmit="both"))
