"""The comparison that decides ``correct``.

A frame's answer is its vertices and its camera.  The distance between two
answers of a frame is the larger of the vertices' and the camera's largest
absolute difference, each divided by how much the reference's answer moves
from frame to frame (the RMS of its differences from the mean frame over
the reference's frames); so it is a share of the part of the answer that
the image decides, whatever the scale of the weights.  A frame with a
missing, misshapen or non-finite answer has an infinite error.

Two numbers are compared, each with a limit of its configuration:

``err_median``
    the median over the checked frames of the distance from the program's
    answer to the reference's: steady from seed to seed, it measures the
    precision of the whole batch;
``nearest_ratio_max``
    the largest over the checked frames of that distance over the distance
    from the frame's reference answer to the nearest other frame's
    reference answer.  A frame that gets another frame's answer reads 1 or
    more; rounding moves the answers of frames whose images are far from
    all others (large activations, large poses) the most, and those have
    the farthest neighbours.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Outputs = Tuple[np.ndarray, np.ndarray]   # vertices (N, V, 3), cam (N, 3)
CHUNK = 16


def spread(a: np.ndarray) -> float:
    """RMS over frames of the differences from the mean frame."""
    a = a.astype(np.float64)
    return float(np.sqrt(np.mean((a - a.mean(axis=0)) ** 2)))


def frame_errors(got: Outputs, ref: Outputs,
                 scales: Sequence[float]) -> np.ndarray:
    """(N,) per-frame distance of ``got`` from ``ref``."""
    errs = []
    for g, r, s in zip(got, ref, scales):
        if g.shape != r.shape:
            return np.full(len(r), np.inf)
        d = np.abs(g.astype(np.float64) - r.astype(np.float64))
        d = d.reshape(len(r), -1).max(axis=1) / s
        errs.append(np.where(np.isfinite(d), d, np.inf))
    return np.maximum(*errs)


def nearest(ref: Outputs, scales: Sequence[float], device) -> np.ndarray:
    """(N,) distance from each reference answer to the nearest other one,
    computed on ``device`` ``CHUNK`` frames at a time."""
    parts = [torch.as_tensor(r.reshape(len(r), -1), dtype=torch.float32,
                             device=device) / s for r, s in zip(ref, scales)]
    n = len(ref[0])
    out = np.empty(n)
    for i in range(0, n, CHUNK):
        d = torch.stack([(p[i:i + CHUNK, None] - p[None]).abs().amax(-1)
                         for p in parts]).amax(0)
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, rows + i] = float("inf")
        out[i:i + CHUNK] = d.amin(1).double().cpu().numpy()
    return out


def check(kept: Sequence, refs: List[Outputs], limits: Dict[str, float],
          device) -> Tuple[bool, Dict[str, dict]]:
    """``kept``: (batch number, distinct batch index, outputs) of the
    window; ``refs``: the reference's outputs of each distinct batch.
    -> (correct, {number: {"value", "limit", "rule"}})."""
    allref = tuple(np.concatenate([r[k] for r in refs]) for k in range(2))
    scales = [spread(a) for a in allref]
    near = nearest(allref, scales, device)
    starts = np.cumsum([0] + [len(r[0]) for r in refs])
    errs, ratios = [], []
    for _, i, out in kept:
        e = frame_errors(out, refs[i], scales)
        errs.append(e)
        ratios.append(e / near[starts[i]:starts[i + 1]])
    frames = sum(len(e) for e in errs)
    if not frames:
        errs = ratios = [np.full(1, np.inf)]
    values = {"err_median": float(np.median(np.concatenate(errs))),
              "nearest_ratio_max": float(np.concatenate(ratios).max())}
    checks = {k: {"value": v, "limit": limits.get(k), "rule": "at most"}
              for k, v in values.items()}
    checks["frames_compared"] = {"value": frames, "limit": 1,
                                 "rule": "at least"}
    correct = frames >= 1 and all(
        limits.get(k) is not None and v <= limits[k]
        for k, v in values.items())
    return correct, checks
