"""One run of one cell: set-up from the seed, the measured window, the traced
parts, and the comparison with the plain reference.

Everything a cell is made of is found by name, so that a configuration, a
traffic mix or a metric is added as new files only:

* ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
* ``benchmark/configs/<config>.json`` (sizes, precision, limits) and
  ``<config>.py`` (``make_inputs``, ``build``, ``layers``, ``reference``,
  ``flops_per_frame``, ``PEAK``);
* ``benchmark/traffic/<traffic>.json``, whose ``loop`` names
  ``benchmark/loops/<loop>.py``;
* ``benchmark/metrics/<metric>.py``, one ``read(run)`` for each metric,
  which returns None where the run has nothing for it to read.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, generate, seeding, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "tpubody_torch"


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    workload: str
    cfg: dict
    mix: dict
    config: Any                  # the configuration's module
    kind: str                    # the card's name
    setup_s: float = 0.0
    window: dict = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    profile: dict = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def span_ms(self, name: str) -> Optional[float]:
        """The median of span ``name`` over the traced batches, or None."""
        values = self.spans.get(name)
        return float(np.median(values)) if values else None


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell_of(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(name: str, bench_dir: str = HERE):
    """(sizes, builder module) of configuration ``name``."""
    cfg = load_json(bench_dir, "configs", name + ".json")
    module = load_module(os.path.join(bench_dir, "configs", name + ".py"),
                         f"benchmark_config_{name}")
    return cfg, module


def mix_of(name: str, bench_dir: str = HERE) -> dict:
    return load_json(bench_dir, "traffic", name + ".json")


def loop_of(mix: dict, bench_dir: str = HERE):
    return load_module(os.path.join(bench_dir, "loops", mix["loop"] + ".py"),
                       f"benchmark_loop_{mix['loop']}")


def reader_of(metric: str, bench_dir: str = HERE) -> Callable:
    return load_module(os.path.join(bench_dir, "metrics", metric + ".py"),
                       "benchmark_metric_" + metric.replace(".", "_")).read


def metrics_of(spec: dict, workload: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, read by nvidia-smi (None where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checked_batches(seed: int, mix: dict) -> List[int]:
    """The batch numbers of the window whose answers are checked: the
    first, and ``checked_batches`` more drawn from the seed among the next
    31 (the loop adds the last)."""
    picks = seeding.numpy_rng(seed, "checked_batches").choice(
        np.arange(1, 32), size=mix["checked_batches"], replace=False)
    return sorted({0, *(int(p) for p in picks)})


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t0: float, device: torch.device, side: str = "program",
             root: str = ROOT, overrides: Optional[dict] = None,
             wrap_step: Callable = lambda step: step) -> dict:
    """One run -> the result object (without the import check, which the
    caller makes once the window has closed).  ``side``: "program", or
    "control" (the reference in the next lower precision in the program's
    place).  ``overrides`` ({"config": {...}, "mix": {...}}) and
    ``wrap_step`` serve the tests, which run cells small on the CPU and
    break the timed path."""
    bench_dir = os.path.join(root, "benchmark")
    spec = benchmark_spec(root)
    cell = cell_of(spec, workload)
    cfg, config = config_of(cell["config"], bench_dir)
    mix = mix_of(cell["traffic"], bench_dir)
    for part, values in (overrides or {}).items():
        {"config": cfg, "mix": mix}[part].update(values)
    loop = loop_of(mix, bench_dir)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    run = Run(workload, cfg, mix, config, kind)

    inputs = config.make_inputs(cfg, seed, device)
    batches = generate.host_batches(mix, cfg["image_size"], seed, device)
    if device.type == "cuda":                # the program's peak from here
        torch.cuda.reset_peak_memory_stats(device)
    if side == "program":
        program = config.build(cfg, inputs, device)
        step = program
    elif side == "control":
        program = None
        control = config.reference(cfg, inputs, control=True)

        def step(host):
            return control(torch.as_tensor(host, device=device))
    else:
        raise ValueError(f"side {side!r}")
    client = loop.Client(wrap_step(step), batches)
    client.run(float("inf"), max_batches=2 * len(batches))  # every shape
    _sync(device)
    run.setup_s = time.perf_counter() - t0

    run.window = client.run(seconds, checked_batches(seed, mix))
    if traced and program is not None:
        _traced_parts(run, client, program, device)
    if device.type == "cuda":
        memory_peak = torch.cuda.max_memory_allocated(device)
    else:
        memory_peak = 0
    run.counters.update(_launches())
    kept = run.window.pop("kept")
    del step, program, batches, client
    _free(device)

    t_ref = time.perf_counter()
    reference = config.reference(cfg, inputs, control=False)
    refs = []
    for i in range(mix["distinct_batches"]):
        images = generate.images(mix["images"], mix["batch"],
                                 cfg["image_size"], seed, f"traffic.batch{i}",
                                 device)
        refs.append(tuple(t.cpu().numpy() for t in reference(images)))
        del images
    correct, checks = compare.check(kept, refs, cfg["limits"], device)
    reference_s = time.perf_counter() - t_ref
    correct = correct and run.window["failed"] == 0

    group = metrics_of(spec, workload, traced)
    metrics = {}
    for m in group:
        value = reader_of(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": 1, "memory_peak_bytes": memory_peak,
           "power_limit_w": power_limit_w() if device.type == "cuda"
           else None}
    result = {"correct": bool(correct),
              "attempted": run.window["attempted"],
              "failed": run.window["failed"], "metrics": metrics,
              "device": dev}
    if traced and run.profile:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["window"] = {k: run.window[k] for k in
                        ("seconds", "frames", "batches")}
    result["setup_s"] = run.setup_s
    result["reference_s"] = reference_s
    result["counters"] = run.counters
    if traced:
        result["spans_ms"] = {k: run.span_ms(k) for k in run.spans}
    result["checks"] = checks
    return result


def _launches() -> Dict[str, int]:
    native = sys.modules.get(PROGRAM + ".native")
    if native is None:
        return {}
    return {f"launches.{k}": v for k, v in native.LAUNCHES.items()}


def _traced_parts(run: Run, client, program, device: torch.device) -> None:
    """The spans of one batch layer by layer, then a profiled slice of the
    normal path.  A layer the program no longer has leaves its spans out
    (their metrics then read nothing); it does not end the run."""
    try:
        layers = run.config.layers(program)
        run.spans = trace.layer_spans(layers, client, device,
                                      run.mix["span_batches"])
    except Exception as e:  # the run goes on without spans
        print(f"spans left out: {e!r}", file=sys.stderr)
    _sync(device)
    before = _launches()
    run.profile = trace.profile(
        lambda after: client.run(float("inf"),
                                 max_batches=run.mix["profiled_batches"] + 1,
                                 after_batch=after),
        run.mix["profiled_batches"], device)
    run.counters.update({k + ".profiled": v - before.get(k, 0)
                         for k, v in _launches().items()})
