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
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (
            f"{path.relative_to(ROOT)} imports {mod}")


def test_importing_the_port_loads_no_jax():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "fl.fused" in " ".join(names) and "kernels.ops" in " ".join(names)


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


@pytest.mark.parametrize("knob,value", [
    ("params_mode", "pytree"), ("pending_dtype", "bfloat16"),
    ("cohort_size", 4), ("scenario", object()), ("compress", "topk"),
    ("slot_dtype", "int8"), ("faults", object()), ("screen", True),
    ("divergence_factor", 2.0), ("checkpoint_every", 5)])
def test_unported_branches_are_refused_by_name(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        _server(device="cpu", **{knob: value})


def test_off_values_of_unported_knobs_are_accepted():
    drv = _server(device="cpu", params_mode="raveled", cohort_size=0,
                  compress=None, screen=False, checkpoint_every=0)
    assert drv.advance(2)[-1]["round"] == 1


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
