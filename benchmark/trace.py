"""Spans around the calls into each layer, and the device trace of a
profiled slice.

:func:`layer_spans` times one batch layer by layer with CUDA events: the
copy of the images to the card, each layer the configuration names, and the
copy of the outputs back to host numpy.  :func:`profile` runs a slice of the
normal path under ``torch.profiler`` and reduces its trace to the window,
the device's busy time (kernels; copies are not kernels), the kernels, the
device operations that took most time and the idle gaps by what the host
was doing.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Layer = Tuple[str, Callable[[dict], None]]
TOP = 10
NAME_CHARS = 160


def _stamp(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    if isinstance(a, float):
        return 1e3 * (b - a)
    return a.elapsed_time(b)


@torch.inference_mode()
def layer_spans(layers: Sequence[Layer], client, device: torch.device,
                iters: int) -> Dict[str, List[float]]:
    """span name -> ms of each of ``iters`` batches of ``client``'s first
    batch: ``step.h2d`` (the copy ``HMRSMPLStep`` makes of the host
    images), the configuration's layers, ``step.d2h`` (the client's copy of
    the answers into its result arrays) and the copies' sum
    ``step.copy``."""
    def h2d(s):
        s["images"] = torch.as_tensor(s["host"], dtype=torch.float32,
                                      device=device)

    def d2h(s):
        client.write((s["verts"], s["cam"]), client.scratch)

    stages = [("step.h2d", h2d)] + list(layers) + [("step.d2h", d2h)]
    spans: Dict[str, List[float]] = defaultdict(list)
    for _ in range(iters):
        state = {"host": client.batches[0]}
        stamps = [_stamp(device)]
        for _, fn in stages:
            fn(state)
            stamps.append(_stamp(device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for (name, _), a, b in zip(stages, stamps, stamps[1:]):
            spans[name].append(_ms(a, b))
        spans["step.copy"].append(spans["step.h2d"][-1]
                                  + spans["step.d2h"][-1])
    return dict(spans)


def profile(run_slice: Callable[[Callable[[], None]], None], batches: int,
            device: torch.device) -> dict:
    """Run ``run_slice(after_batch)``, which runs ``batches + 1`` batches
    and calls ``after_batch`` after each, under ``torch.profiler``; the
    first batch warms the profiler.  -> :func:`summarize` of the trace."""
    from torch.profiler import ProfilerActivity, profile as tprofile, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with tprofile(activities=activities,
                      schedule=schedule(wait=0, warmup=1, active=batches,
                                        repeat=1),
                      on_trace_ready=lambda p: p.export_chrome_trace(path)
                      ) as prof:
            run_slice(prof.step)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[dict]) -> dict:
    """A chrome trace's complete events -> {"window_s", "busy_s", "kernels":
    [(name, start_us, dur_us)], "device_ops", "idle_gaps"}.  The window is
    that of the profiler's steps; ``device_ops`` are kernels and copies by
    total seconds, ``idle_gaps`` the seconds with no kernel running, by what
    the host was doing (the innermost host event at the gap's middle, or the
    copy the device ran then)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in complete
             if str(e.get("name", "")).startswith("ProfilerStep#")]
    if not steps:
        return {}
    lo = min(float(e["ts"]) for e in steps)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in steps)

    def clipped(cat):
        out = []
        for e in complete:
            if e.get("cat") != cat:
                continue
            a = max(float(e["ts"]), lo)
            b = min(float(e["ts"]) + float(e["dur"]), hi)
            if b > a:
                out.append((str(e["name"]), a, b))
        return out

    kernels = clipped("kernel")
    copies = clipped("gpu_memcpy") + clipped("gpu_memset")
    host = [(str(e["name"]), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in complete
            if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                "cuda_driver")
            and not str(e["name"]).startswith("ProfilerStep#")]
    busy = _union([(a, b) for _, a, b in kernels])

    totals: Dict[str, float] = defaultdict(float)
    for name, a, b in kernels + copies:
        totals[name[:NAME_CHARS]] += (b - a) * 1e-6

    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = next((n for n, c0, c1 in copies if c0 <= mid <= c1), None)
        if label is None:
            inside = [(c1 - c0, n) for n, c0, c1 in host if c0 <= mid <= c1]
            label = min(inside)[1] if inside else "host: no op"
        gaps[label[:NAME_CHARS]] += (b - a) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": [(n, a, b - a) for n, a, b in kernels],
            "device_ops": top(totals), "idle_gaps": top(gaps)}
