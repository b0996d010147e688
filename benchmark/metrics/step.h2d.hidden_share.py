"""step.h2d.hidden_share: the share of ``HMRSMPLStep``'s copy in that the
card runs under the step's other work.  For each profiled step, the device
ms of its ``step.h2d`` spans that fall inside the device interval of
another child span of the same ``step`` (the union of them: the backbone
of the chunk before, where the copy goes in chunks on a side stream), over
the ``step.h2d`` spans' summed device ms, in %; the median over the
profiled batches.  A copy made in one piece before the backbone reads 0; a
program without the spans reads nothing."""
import numpy as np

from benchmark import program_spans

COPY = "step.h2d"


def covered(a: float, b: float, intervals) -> float:
    """The length of [a, b] that the union of ``intervals`` covers."""
    total, end = 0.0, a
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, b)
        if e > s:
            total += e - s
            end = e
    return total


def read(run):
    shares = []
    for g in program_spans.roots(run):
        kids = [r for r in g if r["parent"] == g[0]["id"]]
        copies = [r for r in kids if r["name"] == COPY]
        others = [(r["start_ms"], r["end_ms"]) for r in kids
                  if r["name"] != COPY]
        total = sum(r["device_ms"] for r in copies)
        if total > 0:
            hidden = sum(covered(r["start_ms"], r["end_ms"], others)
                         for r in copies)
            shares.append(100.0 * hidden / total)
    return float(np.median(shares)) if shares else None
