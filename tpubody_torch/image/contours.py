"""Ordered boundary extraction (host-side numpy; port of
``tpubody.image.contours``).

The reference uses cv2.findContours (lib/Warp.py:55,78) to obtain an
*ordered* silhouette polygon.  Contour tracing is sequential and
data-dependent, so it stays on the host, implemented first-party with
Moore neighbour tracing.  Everything downstream (DP match, MVC, warping)
consumes the resulting point arrays on the device.
"""
from __future__ import annotations

import math

import numpy as np

# Moore neighborhood in clockwise order, starting from W.
_NEIGHBORS = [(-1, 0), (-1, -1), (0, -1), (1, -1),
              (1, 0), (1, 1), (0, 1), (-1, 1)]


def trace_boundary(mask: np.ndarray) -> np.ndarray:
    """Trace the outer boundary of the first foreground region in scan
    order.

    Args:
      mask: (H, W) binary (nonzero = foreground).

    Returns:
      (N, 2) int array of ordered boundary points as (x, y): the same
      (w, h) column convention as the reference contours (lib/Warp.py:30-31).
    """
    m = np.asarray(mask) != 0
    H, W = m.shape
    pad = np.zeros((H + 2, W + 2), bool)
    pad[1:-1, 1:-1] = m

    # Start: first foreground pixel in scan order.
    ys, xs = np.nonzero(pad)
    if ys.size == 0:
        return np.zeros((0, 2), np.int64)
    start = (ys[0], xs[0])

    contour = [start]
    # Backtrack direction: we entered the start pixel from the West.
    prev_dir = 0
    cur = start
    for _ in range(8 * H * W):  # safety bound
        found = False
        # Search clockwise starting just after the backtrack direction.
        for d in range(8):
            k = (prev_dir + 1 + d) % 8
            dy, dx = _NEIGHBORS[k][1], _NEIGHBORS[k][0]
            ny, nx = cur[0] + dy, cur[1] + dx
            if pad[ny, nx]:
                contour.append((ny, nx))
                # New backtrack dir: opposite of the direction we came from.
                prev_dir = (k + 4) % 8
                cur = (ny, nx)
                found = True
                break
        if not found:
            break  # isolated pixel
        if cur == start and len(contour) > 2:
            contour.pop()  # closing duplicate
            break

    pts = np.array(contour, np.int64)
    # (y, x) padded -> (x, y) unpadded.
    return np.stack([pts[:, 1] - 1, pts[:, 0] - 1], axis=1)


def subsample(contour: np.ndarray, eps: float = 1.0) -> np.ndarray:
    """Evenly subsample an ordered contour by rate ``eps``
    (reference get_smplh_boundary semantics, lib/Warp.py:48-66)."""
    n = contour.shape[0]
    N = max(int(n * eps), 1)
    step = n / N
    idx = [math.floor(i * step) for i in range(N)]
    return contour[np.asarray(idx)]


def simplify(contour: np.ndarray, tol: float = 1.4) -> np.ndarray:
    """Drop collinear runs (coarse equivalent of CHAIN_APPROX_SIMPLE used for
    the photo boundary, lib/Warp.py:78): keep points where the direction
    changes."""
    if contour.shape[0] < 3:
        return contour
    d = np.diff(np.vstack([contour, contour[:1]]), axis=0)
    # Keep where the step direction differs from the previous step's.
    prev = np.roll(d, 1, axis=0)
    keep = np.any(d != prev, axis=1)
    keep[0] = True
    return contour[keep]


def inner_points(mask: np.ndarray) -> np.ndarray:
    """All foreground pixels as (x, y) (reference getinnerpts,
    lib/Warp.py:191)."""
    ys, xs = np.nonzero(np.asarray(mask) != 0)
    return np.stack([xs, ys], axis=1)
