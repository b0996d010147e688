"""The program's own spans of the profiled slice, for the metrics that read
them.

``tpubody_torch.utils.profiling`` keeps a span at each layer boundary of
``HMRSMPLStep`` while a ``torch.profiler`` session records, which in a
``--trace 1`` run is the profiled slice alone: its warm-up batch and the
layer-by-layer batches record none.  The helper reads them from
``sys.modules``, as the harness reads the kernels' launch counters, and
takes the newest ``mix["profiled_batches"]`` roots named ``step``.  A
program without the spans reads nothing.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

MODULE = "tpubody_torch.utils.profiling"
ROOT = "step"


def roots(run) -> List[List[Dict]]:
    """The records of each of the newest ``profiled_batches`` step roots,
    oldest first; [] where the program keeps no spans."""
    read = getattr(sys.modules.get(MODULE), "spans", None)
    if read is None:
        return []
    groups: Dict[int, List[Dict]] = {}
    for r in read():
        groups.setdefault(r["root"], []).append(r)
    steps = [g for g in groups.values()
             if g[0]["parent"] is None and g[0]["name"] == ROOT]
    return steps[-run.mix["profiled_batches"]:]


def span_ms(run, name: str) -> Optional[float]:
    """The device ms of the spans named ``name`` summed within a step, the
    median over the steps that hold one; None where none does."""
    sums = [sum(r["device_ms"] for r in g if r["name"] == name)
            for g in roots(run) if any(r["name"] == name for r in g)]
    return float(np.median(sums)) if sums else None


def self_ms(run) -> Optional[float]:
    """The device ms of the step's interval that no child span covers, the
    median over the steps; None where there are none."""
    values = []
    for g in roots(run):
        root = g[0]
        covered, end = 0.0, root["start_ms"]
        for r in sorted((r for r in g if r["parent"] == root["id"]),
                        key=lambda r: r["start_ms"]):
            a = max(r["start_ms"], end)
            b = min(r["end_ms"], root["end_ms"])
            if b > a:
                covered += b - a
            end = max(end, b)
        values.append(root["device_ms"] - covered)
    return float(np.median(values)) if values else None
