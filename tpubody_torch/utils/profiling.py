"""Per-stage timing + optional profiler traces (port of
``tpubody.utils.profiling``).

The reference's observability is ad-hoc time.time() deltas and tqdm.write.
This provides structured stage timers with a report, and wraps each stage
in ``torch.profiler`` when a trace dir is set (TPUBODY_TRACE_DIR env var
or explicit argument): one Chrome trace file per stage.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


def _sync() -> None:
    """Wait for the card, where one is in use: PyTorch returns before the
    device finishes, so a stage's host time means nothing without it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Collects named stage durations; optionally emits a profiler trace
    around each stage.  A stage ends in a device synchronisation."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir or os.environ.get("TPUBODY_TRACE_DIR")
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        prof = None
        if self.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
        _sync()
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            yield
            _sync()
        self.records.append(
            {"stage": name, "seconds": round(time.perf_counter() - t0, 4)})
        if prof is not None:
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.trace_dir, name.replace("/", "_") + ".json"))

    def report(self) -> str:
        lines = [f"{r['stage']:<28s} {r['seconds']:>9.3f}s"
                 for r in self.records]
        total = sum(r["seconds"] for r in self.records)
        lines.append(f"{'TOTAL':<28s} {total:>9.3f}s")
        return "\n".join(lines)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.records, f, indent=1)
