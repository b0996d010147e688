"""The harness on the CPU at a tiny size: what it finds by name, what it
imports, what it refuses, and that a broken timed path or the control comes
out not correct.  ``test_cell_on_the_card`` runs a cell on the card."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness, trace

ROOT = harness.ROOT
CELLS = ("hmr_bf16.offline_b512", "hmr_int8.offline_b512")
SEED = 2 ** 32 + 101
TINY = {"mix": {"batch": 2, "span_batches": 1, "profiled_batches": 1,
                "checked_batches": 1},
        "config": {"image_size": 64, "stage_sizes": [1, 1, 1, 1]}}


def tiny(**extra):
    out = {k: dict(v) for k, v in TINY.items()}
    for k, v in extra.items():
        out[k].update(v)
    return out


def run_tiny(workload, root=ROOT, traced=False, **kw):
    kw.setdefault("overrides", tiny())
    return harness.run_cell(workload, SEED, 0.3, traced, time.perf_counter(),
                            torch.device("cpu"), root=root, **kw)


def test_sound_int8_run_is_correct_and_reports_its_metrics():
    result = run_tiny(CELLS[1], traced=True)
    assert result["correct"], result["checks"]
    assert result["checks"]["nearest_ratio_max"]["value"] < 1e-2
    assert set(result["metrics"]) >= {"step.copy_ms", "hmr_quant.backbone_ms",
                                      "lbs.prologue_ms"}
    assert list(result)[-1] == "checks"


def test_untraced_run_reports_the_end_to_end_metrics():
    result = run_tiny(CELLS[0])
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert result["attempted"] >= result["window"]["frames"] > 0


# -- the timed path broken underneath -----------------------------------
def stale(step):
    """Each call returns the previous call's answers."""
    last = []

    def broken(host):
        out = step(host)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return broken


def half_left_out(step):
    """The second half of each batch gets the mean answer of the first."""
    def broken(host):
        verts, cam = step(host)
        h = len(verts) // 2
        verts, cam = verts.clone(), cam.clone()
        verts[h:] = verts[:h].mean(0)
        cam[h:] = cam[:h].mean(0)
        return verts, cam
    return broken


def altered(step):
    """One frame's answer is altered: its vertices twice as far from the
    origin."""
    def broken(host):
        verts, cam = step(host)
        verts = verts.clone()
        verts[0] *= 2
        return verts, cam
    return broken


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", (stale, half_left_out, altered))
def test_broken_timed_path_is_not_correct(workload, fault):
    result = run_tiny(workload, wrap_step=fault)
    assert not result["correct"], (fault.__name__, result["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cfg, _ = harness.config_of(harness.cell_of(harness.benchmark_spec(),
                                               workload)["config"])
    result = run_tiny(workload, side="control")
    assert any(c["value"] > cfg["limits"][k]
               for k, c in result["checks"].items() if k in cfg["limits"])
    assert not result["correct"]


# -- found by name --------------------------------------------------------
def test_new_config_traffic_and_metric_are_new_files_only(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench = tmp_path / "benchmark"
    cfg = json.load(open(bench / "configs" / "hmr_r50_spin_int8.json"))
    cfg["name"] = "hmr_r50_spin_int8_copy"
    (bench / "configs" / "hmr_r50_spin_int8_copy.json").write_text(
        json.dumps(cfg))
    shutil.copy(bench / "configs" / "hmr_r50_spin_int8.py",
                bench / "configs" / "hmr_r50_spin_int8_copy.py")
    mix = json.load(open(bench / "traffic" / "offline_batches.json"))
    mix["distinct_batches"] = 3
    (bench / "traffic" / "offline_three.json").write_text(json.dumps(mix))
    (bench / "metrics" / "batches_run.py").write_text(
        "def read(run):\n    return run.window['batches']\n")
    spec["configs"].append({"name": "hmr_r50_spin_int8_copy"})
    spec["workloads"].append({"name": "copy.three", "chips": 1,
                              "config": "hmr_r50_spin_int8_copy",
                              "traffic": "offline_three"})
    spec["end_to_end"].append({"name": "batches_run", "unit": "batches",
                               "workloads": ["copy.three"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result = run_tiny("copy.three", root=str(tmp_path))
    assert result["correct"], result["checks"]
    assert result["metrics"]["batches_run"]["value"] == \
        result["window"]["batches"] >= 1
    assert "frames_per_s" not in result["metrics"]


# -- what the harness loads, and when it refuses ---------------------------
def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=cwd)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code = (
        "import time, torch\n"
        "from benchmark import harness, readings, run\n"
        f"harness.run_cell({CELLS[1]!r}, {SEED}, 0.2, True, "
        "time.perf_counter(), torch.device('cpu'), "
        f"overrides={TINY!r})\n"
        "print(run.forbidden_modules())\n"
        "import sys\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} "
        "& {'tpubody', 'tpubody_torch', 'jax'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['tpubody_torch']"       # compared whole


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    for name in [m for m in sys.modules if m.split(".")[0] == "tpubody"]:
        monkeypatch.delitem(sys.modules, name)
    before = set(run.forbidden_modules())     # the test process's own JAX
    monkeypatch.setitem(sys.modules, "tpubody_torch_lookalike", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "tpubody.core", sys)
    assert set(run.forbidden_modules()) == before | {"tpubody"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import time, torch\nfrom benchmark import harness\n"
            f"harness.run_cell({CELLS[0]!r}, 1, 0.2, False, "
            f"time.perf_counter(), torch.device('cpu'), overrides={TINY!r})\n"
            "print('result')\n")
    out = _python(code, cwd=str(tmp_path))
    assert out.returncode != 0 and "result" not in out.stdout
    assert "tpubody_torch" in out.stderr


def test_result_line_is_strict_json():
    from benchmark import run

    line = json.dumps(run.finite({"a": float("inf"),
                                  "b": [float("nan"), 1.0]}))
    assert json.loads(line) == {"a": None, "b": [None, 1.0]}


def test_trace_summary():
    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [ev("ProfilerStep#1", "user_annotation", 0, 100),
              ev("k1", "kernel", 10, 20), ev("k2", "kernel", 25, 15),
              ev("k1", "kernel", 70, 10),
              ev("Memcpy HtoD", "gpu_memcpy", 45, 20),
              ev("aten::copy_", "cpu_op", 40, 30),
              ev("aten::cat", "cpu_op", 85, 10),
              ev("outer", "user_annotation", 80, 20)]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)       # [10, 40] and [70, 80]
    gaps = dict(s["idle_gaps"])
    assert gaps["Memcpy HtoD"] == pytest.approx(30e-6)       # [40, 70]
    assert gaps["aten::cat"] == pytest.approx(20e-6)         # [80, 100]
    assert gaps["host: no op"] == pytest.approx(10e-6)       # [0, 10]
    ops = dict(s["device_ops"])
    assert ops["k1"] == pytest.approx(30e-6) and ops["Memcpy HtoD"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = harness.run_cell(workload, SEED, 2.0, True, time.perf_counter(),
                              torch.device("cuda", 0))
    assert result["correct"], result["checks"]
    assert 0 < result["metrics"]["fused_lbs_roofline"]["value"] <= 100
    assert 0 < result["metrics"]["step_mfu"]["value"] <= 100
    assert np.isfinite(result["device"]["busy_s"])
