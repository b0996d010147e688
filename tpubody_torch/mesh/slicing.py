"""Plane/mesh intersection utilities (replaces trimesh slice_plane/section;
the port's own copy of ``tpubody.mesh.slicing``, numpy on the host).

Used by 3D-joint recovery (lib/Depth2Mesh_Bspline.py:466-492) and hand
replacement (lib/Replace_Hands.py:142-362).  All operations are vectorized
over faces; the attribute-carrying cut (``cut_faces_plane``) interpolates
the full (3 + C) attribute rows at the intersection points, which is what
the reference's custom ``slice_faces_plane`` does for its (n, 30) points.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


def signed_distance(pts: np.ndarray, origin: np.ndarray,
                    normal: np.ndarray) -> np.ndarray:
    """Computed in the input dtype: float32 meshes (the 1024^2 stitch
    output is ~1M verts) stay float32 — converting to f64 per call was a
    measured hotspot of 3D-joint recovery."""
    pts = np.asarray(pts)
    dt = pts.dtype if pts.dtype == np.float32 else np.float64
    n = np.asarray(normal, dt)
    n = n / max(np.linalg.norm(n), 1e-12)
    return (pts - np.asarray(origin, dt)) @ n


def halfspace_vertex_mask(verts: np.ndarray, origin, normal) -> np.ndarray:
    """True for vertices on the positive side of the plane."""
    return signed_distance(verts, origin, normal) >= 0.0


def restrict_faces(faces: np.ndarray, vert_mask: np.ndarray) -> np.ndarray:
    """Faces whose three corners all satisfy the mask (coarse slice_plane)."""
    f = np.asarray(faces)
    keep = vert_mask[f].all(axis=1)
    return f[keep]


def section_segments(
    verts: np.ndarray, faces: np.ndarray, origin, normal,
) -> Tuple[np.ndarray, np.ndarray]:
    """Plane cross-section as line segments.

    Returns (segments (S, 2, 3), face_ids (S,)): for every face crossing the
    plane, the two edge-intersection points.
    """
    v = np.asarray(verts)
    if v.dtype != np.float32:
        v = np.asarray(v, np.float64)
    f = np.asarray(faces)
    d_full = signed_distance(v, origin, normal)
    df = d_full[f]                                     # (F, 3)
    # Restrict all per-edge work to faces that can intersect the plane
    # (sign change or on-plane vertex) — typically a tiny fraction.
    may_cut = ~((df > 0).all(axis=1) | (df < 0).all(axis=1))
    face_rows = np.flatnonzero(may_cut)
    f = f[may_cut]
    d = df[may_cut]

    pts = []
    valid = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        da, db = d[:, a], d[:, b]
        crossing = (da * db) < 0
        t = np.where(crossing, da / np.where(crossing, da - db, 1.0), 0.0)
        p = v[f[:, a]] + t[:, None] * (v[f[:, b]] - v[f[:, a]])
        pts.append(p)
        valid.append(crossing)
    pts = np.stack(pts, axis=1)                        # (F, 3, 3)
    valid = np.stack(valid, axis=1)                    # (F, 3)

    # A vertex exactly on the plane (d == 0) also counts as a cut point.
    on_plane = np.isclose(d, 0.0)
    for c in range(3):
        extra = on_plane[:, c] & (valid.sum(1) < 2)
        # register the vertex itself in the first invalid slot
        vidx = f[extra, c]
        for row, vi in zip(np.nonzero(extra)[0], vidx):
            slot = np.argmin(valid[row])
            pts[row, slot] = v[vi]
            valid[row, slot] = True

    nvalid = valid.sum(axis=1)
    cut = nvalid >= 2
    if not cut.any():
        return np.zeros((0, 2, 3)), np.zeros((0,), np.int64)
    # order valid points first; take the first two
    order = np.argsort(~valid[cut], axis=1, kind="stable")
    rows = np.nonzero(cut)[0]
    p0 = pts[rows, order[:, 0]]
    p1 = pts[rows, order[:, 1]]
    return np.stack([p0, p1], axis=1), face_rows[rows]


def section_centroid(verts: np.ndarray, faces: np.ndarray, origin, normal
                     ) -> Optional[np.ndarray]:
    """Length-weighted centroid of the plane cross-section polyline
    (trimesh ``mesh.section(...).centroid`` parity for joint recovery,
    lib/Depth2Mesh_Bspline.py:483-491)."""
    segs, _ = section_segments(verts, faces, origin, normal)
    if segs.shape[0] == 0:
        return None
    lengths = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=1)
    mids = segs.mean(axis=1)
    total = lengths.sum()
    if total < 1e-12:
        return mids.mean(axis=0)
    return (mids * lengths[:, None]).sum(axis=0) / total


class CutResult(NamedTuple):
    points: np.ndarray        # (N', 3 + C) kept + newly created points
    faces: np.ndarray         # (F', 3)
    boundary: np.ndarray      # indices (into points) of new cut-edge points
    tracked: Optional[np.ndarray] = None  # remapped external indices


def cut_faces_plane(points: np.ndarray, faces: np.ndarray, origin, normal,
                    track: Optional[np.ndarray] = None) -> CutResult:
    """Cut an attribute mesh by a plane, keeping the positive side.

    Attribute-carrying redesign of the reference's slice_faces_plane
    (lib/Replace_Hands.py:142-362): triangles crossing the plane are split,
    with new vertices' full attribute rows (position, color, weights...)
    linearly interpolated along the cut edges; returns the ordered set of
    new boundary vertices for downstream stitching.
    """
    pts = np.asarray(points, np.float64)
    f = np.asarray(faces)
    v = pts[:, :3]
    d_all = signed_distance(v, origin, normal)
    inside = d_all >= 0.0

    n_in = inside[f].sum(axis=1)
    keep_faces = f[n_in == 3]

    new_points = []
    new_faces = []
    boundary_ids = []
    next_id = pts.shape[0]
    edge_cache = {}

    def cut_point(a: int, b: int) -> int:
        nonlocal next_id
        key = (min(a, b), max(a, b))
        if key in edge_cache:
            return edge_cache[key]
        da, db = d_all[a], d_all[b]
        t = da / (da - db)
        row = pts[a] + t * (pts[b] - pts[a])
        new_points.append(row)
        edge_cache[key] = next_id
        boundary_ids.append(next_id)
        next_id += 1
        return edge_cache[key]

    crossing = f[(n_in == 1) | (n_in == 2)]
    for tri in crossing:
        ins = [int(i) for i in tri if inside[i]]
        outs = [int(i) for i in tri if not inside[i]]
        if len(ins) == 1:
            a = ins[0]
            p1 = cut_point(a, outs[0])
            p2 = cut_point(a, outs[1])
            # preserve orientation: find the cyclic order of a in tri
            new_faces.append([a, p1, p2] if _oriented(tri, a, outs[0])
                             else [a, p2, p1])
        else:
            a, b = ins
            p1 = cut_point(a, outs[0])
            p2 = cut_point(b, outs[0])
            if _oriented(tri, a, b):
                new_faces.append([a, b, p2])
                new_faces.append([a, p2, p1])
            else:
                new_faces.append([b, a, p1])
                new_faces.append([b, p1, p2])

    all_points = np.vstack([pts] + new_points) if new_points else pts
    all_faces = np.vstack([keep_faces] + [np.asarray(new_faces, np.int64)]
                          ) if new_faces else keep_faces

    # Compact: drop unreferenced vertices.
    used, inverse = np.unique(all_faces.ravel(), return_inverse=True)
    remap = {int(old): i for i, old in enumerate(used)}
    out_faces = inverse.reshape(-1, 3)
    out_points = all_points[used]
    out_boundary = np.asarray(
        [remap[b] for b in boundary_ids if b in remap], np.int64)
    out_tracked = None
    if track is not None:
        out_tracked = np.asarray(
            [remap[int(t)] for t in track if int(t) in remap], np.int64)
    return CutResult(points=out_points, faces=out_faces,
                     boundary=out_boundary, tracked=out_tracked)


def section_ring(verts: np.ndarray, faces: np.ndarray, origin, normal,
                 near: Optional[np.ndarray] = None) -> np.ndarray:
    """Ordered closed polyline of a plane cross-section.

    Chains the per-face intersection segments into loops by endpoint
    adjacency and returns the loop whose centroid is closest to ``near``
    (trimesh ``mesh.section`` + discrete-path parity, used for the wrist
    rings in lib/Replace_Hands.py:678-691).
    """
    segs, _ = section_segments(verts, faces, origin, normal)
    if segs.shape[0] == 0:
        return np.zeros((0, 3))
    # Merge endpoints by rounding to tolerance.
    pts = segs.reshape(-1, 3)
    key = np.round(pts / 1e-6).astype(np.int64)
    _, uniq_idx, inverse = np.unique(key, axis=0, return_index=True,
                                     return_inverse=True)
    upts = pts[uniq_idx]
    edges = inverse.reshape(-1, 2)

    # Adjacency walk.
    adj = {}
    for a, b in edges:
        if a == b:
            continue
        adj.setdefault(int(a), []).append(int(b))
        adj.setdefault(int(b), []).append(int(a))

    visited = set()
    loops = []
    for start in adj:
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = -1, start
        for _ in range(len(adj) + 1):
            nxts = [v for v in adj[cur] if v != prev and v not in visited]
            if not nxts:
                break
            nxt = nxts[0]
            loop.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        if len(loop) >= 3:
            loops.append(np.asarray(loop))
    if not loops:
        return np.zeros((0, 3))
    if near is None or len(loops) == 1:
        loop = max(loops, key=len)
    else:
        near = np.asarray(near)
        loop = min(loops, key=lambda l: np.linalg.norm(
            upts[l].mean(axis=0) - near))
    return upts[loop]


def ring_length(ring: np.ndarray) -> float:
    """Closed polyline circumference."""
    if ring.shape[0] < 2:
        return 0.0
    closed = np.vstack([ring, ring[:1]])
    return float(np.linalg.norm(np.diff(closed, axis=0), axis=1).sum())


def _oriented(tri, a, b) -> bool:
    """True if b directly follows a in the cyclic order of tri."""
    t = [int(x) for x in tri]
    ia = t.index(int(a))
    return t[(ia + 1) % 3] == int(b)
