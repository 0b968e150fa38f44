"""The port's benches (``repro_torch.bench``): the artifact differ against
the reference's on the same synthetic artifacts, the entry point's module
list and refusals, the artifacts' environment record, and the kernel,
engine, fused-round and round-perf benches on the CPU at K <= 8, with the
reference's row names. Fixed seeds, no Hypothesis."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from benchmarks import diff as rdiff  # noqa: E402
from repro_torch.bench import diff as tdiff  # noqa: E402
from repro_torch.bench import run as trun  # noqa: E402


def _write(d, name, rows, **extra):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"BENCH_{name}.json"), "w") as f:
        json.dump({"name": name, "rows": rows, **extra}, f)


def _artifacts(tmp_path):
    """Baseline and current directories covering every verdict: a
    regression, a pass, a noise-floor row, a new row, a sentinel, a new
    artifact, an environment mismatch and an unreadable file."""
    base, cur = str(tmp_path / "base"), str(tmp_path / "cur")
    env = dict(backend="cuda", device_count=1)
    _write(base, "round", [{"name": "big", "us_per_call": 50_000.0},
                           {"name": "ok", "us_per_call": 20_000.0},
                           {"name": "tiny", "us_per_call": 50.0},
                           {"name": "ratio", "us_per_call": 0}], **env)
    _write(cur, "round", [{"name": "big", "us_per_call": 150_000.0},
                          {"name": "ok", "us_per_call": 25_000.0},
                          {"name": "tiny", "us_per_call": 900.0},
                          {"name": "ratio", "us_per_call": 0},
                          {"name": "new_row", "us_per_call": 1.0}], **env)
    _write(base, "moved", [{"name": "r", "us_per_call": 5_000.0}],
           backend="cpu", device_count=1)
    _write(cur, "moved", [{"name": "r", "us_per_call": 50_000.0}], **env)
    _write(cur, "fresh", [{"name": "a", "us_per_call": 9.0}], **env)
    with open(os.path.join(cur, "BENCH_broken.json"), "w") as f:
        f.write("{not json")
    return base, cur


@pytest.mark.parametrize("ratio,min_us", [(2.0, 1000.0), (1.1, 1000.0),
                                          (2.0, 10.0), (40.0, 1.0)])
def test_diff_verdicts_match_reference(tmp_path, ratio, min_us):
    base, cur = _artifacts(tmp_path)
    want = rdiff.diff_artifacts(rdiff.load_artifacts(base),
                                rdiff.load_artifacts(cur), ratio, min_us)
    got = tdiff.diff_artifacts(tdiff.load_artifacts(base),
                               tdiff.load_artifacts(cur), ratio, min_us)
    assert got == want
    assert tdiff.load_artifacts(cur, ["round"]) == \
        rdiff.load_artifacts(cur, ["round"])


@pytest.mark.parametrize("argv", [
    [], ["--ratio", "1.1"], ["--min-us", "10"], ["--ratio", "40"],
    ["fresh"], ["moved"], ["nothing_matches"]],
    ids=["default", "tight", "low_floor", "loose", "fresh", "moved",
         "none"])
def test_diff_exit_codes_and_report_match_reference(tmp_path, capsys,
                                                    argv):
    base, cur = _artifacts(tmp_path)
    args = ["--baseline", base, "--current", cur] + argv
    want = rdiff.main(args)
    want_out = capsys.readouterr()
    got = tdiff.main(args)
    got_out = capsys.readouterr()
    assert got == want
    assert got_out.out == want_out.out
    assert got_out.err == want_out.err


def test_diff_usage_errors_match_reference(tmp_path, monkeypatch):
    missing = str(tmp_path / "missing")
    assert tdiff.main(["--baseline", missing]) == 2 == \
        rdiff.main(["--baseline", missing])
    with pytest.raises(SystemExit) as e:
        tdiff.main([])
    assert e.value.code == 2
    # the current directory defaults to the port's own artifacts
    monkeypatch.delenv("REPRO_BENCH_OUT", raising=False)
    monkeypatch.chdir(tmp_path)
    _write("experiments/bench_torch", "x", [{"name": "a",
                                             "us_per_call": 5000.0}])
    _write("base", "x", [{"name": "a", "us_per_call": 1000.0}])
    assert tdiff.main(["--baseline", "base"]) == 1


NOT_PORTED = ["roofline", "sharded_round", "sharded", "grouped_round",
              "grouped", "tp_round", "tp", "cohort_round", "cohort",
              "fault_round", "fault"]


@pytest.mark.parametrize("name", NOT_PORTED)
def test_run_refuses_unported_modules_by_name(name, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    module = trun.ALIASES[name]
    with pytest.raises(NotImplementedError, match=module):
        trun.main(["--device", "cpu", "bound", name])
    assert not os.listdir(tmp_path)           # refused before anything ran


def test_run_module_list_and_aliases_follow_the_reference():
    from benchmarks import run as rrun
    ported = [m for m in rrun.MODULES if m not in trun.NOT_PORTED]
    assert trun.MODULES == ported
    assert set(trun.NOT_PORTED) - {"fault_round_bench"} == \
        set(rrun.MODULES) - set(ported)
    for alias, target in rrun.ALIASES.items():
        assert trun.ALIASES[alias] == target
    assert trun.resolve_modules([]) == trun.MODULES
    assert trun.resolve_modules(["kernels", "fused", "engine"]) == [
        "kernels_bench", "fused_round_bench", "fl_engine_bench"]
    with pytest.raises(ValueError, match="unknown bench module"):
        trun.resolve_modules(["fig5"])


def test_run_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["bound"])


def test_run_writes_one_artifact_per_module_that_diffs_clean(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    assert trun.main(["--device", "cpu", "bound", "kernels"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert sorted(os.listdir(tmp_path)) == ["BENCH_bound.json",
                                            "BENCH_kernels.json"]
    for name in ("bound", "kernels"):
        with open(tmp_path / f"BENCH_{name}.json") as f:
            art = json.load(f)
        assert art["name"] == name and art["backend"] == "cpu"
        assert art["device_count"] == 1 and art["nvidia_smi"] is None
        assert art["torch"] == torch.__version__
        assert all(set(r) >= {"name", "us_per_call", "derived"}
                   for r in art["rows"])
    assert tdiff.main(["--baseline", str(tmp_path), "--current",
                       str(tmp_path)]) == 0


def test_kernels_bench_rows_match_reference_names_on_cpu():
    """On the CPU only the twin (``_ref_``) rows run, by the reference's
    names and derived columns; the twins agree with the port's f64
    oracles on the bench's own inputs."""
    from benchmarks import kernels_bench as rkb
    from repro_torch.bench import kernels_bench as tkb
    from repro_torch.kernels import ref
    want, got = rkb.run(), tkb.run(device="cpu")
    assert [(r["name"], r["derived"]) for r in got] == [
        (r["name"], r["derived"]) for r in want]
    assert all(r["us_per_call"] > 0 for r in got)
    oracles = [ref.aircomp_sum_ref, ref.cosine_partials_ref,
               lambda x, g: ref.round_stats_ref(x, g, x),
               ref.superpose_normalize_ref,
               lambda q: ref.swa_attention_ref(q, q, q, window=128)]
    for (_, name, twin, _, args, _), oracle in zip(tkb.cases("cpu"),
                                                   oracles):
        for a, w in zip(torch.utils._pytree.tree_leaves(twin(*args)),
                        torch.utils._pytree.tree_leaves(oracle(*args))):
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=3e-5,
                                       atol=3e-5, err_msg=name)


def _finite_rows(rows, names):
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert np.isfinite(r["us_per_call"]) and r["us_per_call"] >= 0
        assert r["derived"]


def test_fused_round_smoke_on_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.bench import fused_round_bench as frb
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    frb.main(["smoke", "--device", "cpu"])
    assert "# artifact ->" in capsys.readouterr().out
    with open(tmp_path / "BENCH_fused_round_smoke.json") as f:
        rows = json.load(f)["rows"]
    _finite_rows(rows, ["fused_round/host_k8", "fused_round/fused_k8",
                        "fused_round/speedup_k8"])
    assert "scan_rounds=5" in rows[1]["derived"]


def test_round_perf_and_fl_engine_on_cpu(monkeypatch):
    """The round-perf series (the reference's local rows, in its order) on
    the d = 55,050 MLP at K = 4, 2 rounds per advance, and the batched
    engine bench at K = 8."""
    from repro_torch.bench import fl_engine_bench as feb
    from repro_torch.bench import round_perf_bench as rpb
    monkeypatch.setattr(rpb, "_ROUNDS", {4: 2})
    monkeypatch.delenv("REPRO_BENCH_HIDDEN", raising=False)
    _finite_rows(rpb.run("cpu", ks=(4,)), [
        "round_perf/host_raveled_k4", "round_perf/fused_raveled_k4",
        "round_perf/fused_raveled_delta_k4", "round_perf/fused_pytree_k4",
        "round_perf/fused_pytree_delta_k4"])
    params, _ = rpb._world(4, torch.device("cpu"))
    assert params["l1"]["w"].shape == (784, 64)
    _finite_rows(feb.run("cpu", ks=(8,)), ["fl_engine/batched_k8",
                                           "fl_engine/server_batched_k8"])


def test_timing_helpers_on_cpu():
    from repro_torch.bench import timing
    calls = []
    assert timing.call_us(lambda: calls.append(1), "cpu", runs=3) >= 0
    assert len(calls) == 4                    # one warm-up, three timed
    assert timing.median_s(lambda: None, 3, torch.device("cpu")) >= 0
    timing.sync("cpu")
