"""Monotone boundary correspondence by dynamic programming (port of
``tpubody.image.boundary_match``).

Capability parity with the reference's DP boundary match
(lib/Warp.py:99-165): given two ordered silhouette contours, assign each
photo-boundary point a SMPL-boundary point such that indices advance
monotonically (window k) and total point distance is minimal.

The DP runs over photo points with the whole cost row as its state: each
step is a windowed minimum over the k previous columns plus a distance
add, a handful of small launches on the device (``tpubody`` compiles the
loop as a ``lax.scan``).  Backtracking walks the argmin table on the host
(the C++ helper of :mod:`tpubody_torch.geometry`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpubody_torch import geometry
from tpubody_torch.device import DeviceLike, resolve

_INF = 1e12


def _windowed_min(row: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each j: min over j' in [j-k, j-1] of row[j'], plus its argmin
    (columns before 0 count as ``_INF``).

    On ties the NEAREST column wins (the smallest shift), which is what
    ``jnp.argmin`` over tpubody's stack of shifted copies returns; it is
    taken by an explicit rule, not left to ``argmin``'s tie-breaking.
    """
    n = row.shape[0]
    padded = torch.cat([row.new_full((k,), _INF), row])
    win = padded.unfold(0, k, 1)[:n]          # win[j, s] = row[j - k + s]
    best = win.amin(dim=1)
    s = torch.arange(k, device=row.device)
    last = torch.where(win == best[:, None], s, s.new_full((), -1)
                       ).amax(dim=1)          # largest s = smallest shift
    idx = torch.arange(n, device=row.device) - (k - last)
    return best, idx


def _dp_tables(dist: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dist: (m, n) photo-to-smpl distances.  Returns the final cost row
    and the (m - 1, n) argmin backpointer table."""
    m, n = dist.shape
    args = torch.empty((m - 1, n), dtype=torch.int64, device=dist.device)
    row = dist[0]
    for i in range(1, m):
        best, args[i - 1] = _windowed_min(row, k)
        row = dist[i] + best
    return row, args


def match_boundaries(
    smpl_bound: np.ndarray,   # (n, 2) ordered SMPL silhouette points
    rgb_bound: np.ndarray,    # (m, 2) ordered photo silhouette points
    k: int = 64,
    device: Optional[DeviceLike] = "cuda",
) -> np.ndarray:
    """Match each photo boundary point to a SMPL boundary point.

    Both contours must start near corresponding locations (they are traced
    from the same scan order, so they do).  Returns (m,) indices into
    ``smpl_bound``, monotonically non-decreasing (window ``k``).
    """
    dev = resolve(device)
    sb = torch.as_tensor(np.asarray(smpl_bound), dtype=torch.float32,
                         device=dev)
    rb = torch.as_tensor(np.asarray(rgb_bound), dtype=torch.float32,
                         device=dev)
    # Pairwise distance via the |a|^2 - 2ab + |b|^2 expansion.  The product
    # is written out over its two coordinates: plain float32 multiplies,
    # whatever the matmul precision flags say.
    ab = rb[:, 0:1] * sb[None, :, 0] + rb[:, 1:2] * sb[None, :, 1]
    d2 = ((rb ** 2).sum(dim=1)[:, None] - 2.0 * ab
          + (sb ** 2).sum(dim=1)[None, :])
    dist = torch.sqrt(torch.clamp(d2, min=0.0))

    final_row, args = _dp_tables(dist, k)
    m = rb.shape[0]

    # Backtrack (host-sequential, the C++ helper).
    args_np = args.cpu().numpy()                   # (m-1, n)
    match = geometry.dp_backtrack(args_np, int(torch.argmin(final_row)))
    return np.clip(match, 0, smpl_bound.shape[0] - 1)


def dp_backtrack_reference(args: np.ndarray, j: int) -> np.ndarray:
    """The plain version of :func:`tpubody_torch.geometry.dp_backtrack`:
    the walk back through the (m-1, n) argmin table in Python."""
    out = [int(j)]
    for i in range(args.shape[0] - 1, -1, -1):
        j = int(args[i, j])
        out.append(j)
    return np.asarray(out[::-1], np.int64)
