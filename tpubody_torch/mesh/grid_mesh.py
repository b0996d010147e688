"""Depth-map -> grid mesh with static topology, plus boundary-ring walking
(port of ``tpubody.mesh.grid_mesh``, numpy and the C++ host-geometry
helper on the host).

Capability parity with the reference's depth2trimesh + get_bound_verts_index
(lib/Depth2Mesh_Bspline.py:33-108, 196-234), re-designed:

  * grid-face generation is fully vectorized (the reference already is) but
    the *boundary walk* — an O(n^2) sequential np.delete loop in the
    reference — becomes an O(n) successor-map walk on host,
  * the mesh carries an (N, 3+3+K) attribute matrix (position, color,
    skinning weights) exactly like the reference's "points" arrays, so
    downstream stitching interpolates everything at once.

Grid meshes from depth maps have a fixed topology (the mask only gates
validity), so this layer stays on the host.  The grid triangulation, the
once-only edges and the ring walk run in the C++ helper
(:mod:`tpubody_torch.geometry`); their numpy/Python versions stay here as
the plain versions (``*_reference``), which only the tests call.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from tpubody_torch import geometry


class AttrMesh(NamedTuple):
    """Mesh with per-vertex attribute block: columns [x, y, z, r, g, b, w...]."""

    points: np.ndarray  # (N, 3 + C)
    faces: np.ndarray   # (F, 3) int

    @property
    def verts(self) -> np.ndarray:
        return self.points[:, :3]

    @property
    def colors(self) -> np.ndarray:
        return self.points[:, 3:6]


def rotation_about_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def back_rotation_angle(front_depth: np.ndarray, back_depth: np.ndarray,
                        J_2d: np.ndarray) -> float:
    """Angle between the front and back shoulder-line vectors (reference
    back_trimesh_trans_angel, lib/Depth2Mesh_Bspline.py:356-369; joints 16/17
    are the shoulders)."""
    j16 = J_2d[16].astype(int)
    j17 = J_2d[17].astype(int)
    v1 = np.array([j16[1] - j17[1], j16[0] - j17[0],
                   front_depth[j16[1], j16[0]] - front_depth[j17[1], j17[0]]])
    v2 = np.array([j16[1] - j17[1], j16[0] - j17[0],
                   back_depth[j16[1], j16[0]] - back_depth[j17[1], j17[0]]])
    denom = np.linalg.norm(v1) * np.linalg.norm(v2)
    if denom < 1e-12:
        return 0.0
    c = np.clip(np.dot(v1, v2) / denom, -1.0, 1.0)
    return float(np.arccos(c))


def depth_to_mesh(
    depth: np.ndarray,            # (H, W)
    color: np.ndarray,            # (H, W, 3)
    weights: np.ndarray,          # (H, W, K)
    mask: np.ndarray,             # (H, W) valid pixels
    is_back: bool = False,
    rotate_y: Optional[float] = None,
) -> AttrMesh:
    """Grid-triangulate the valid region of a depth map.

    Vertices are (x=col, y=row, z=depth) with color+weight attributes; faces
    connect valid 2x2 pixel quads (two triangles), with winding flipped for
    the back surface.  Vertices not referenced by any face are dropped and
    faces reindexed.  The back sheet is then rotated about y by
    ``rotate_y`` in float32 (``tpubody``'s native path does the same).
    """
    m = np.asarray(mask).astype(bool)
    points, faces = geometry.grid_mesh_build(m, depth, color, weights,
                                             is_back)
    if is_back and rotate_y:
        R = rotation_about_y(rotate_y)
        points[:, :3] = points[:, :3] @ R.T.astype(np.float32)
    return AttrMesh(points=points, faces=faces)


def grid_mesh_build_reference(mask: np.ndarray, depth: np.ndarray,
                              color: np.ndarray, weights: np.ndarray,
                              is_back: bool
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`tpubody_torch.geometry.grid_mesh_build`
    in numpy -> (points (N, 6+K) float32, faces (F, 3) int64)."""
    H, W = depth.shape
    m = np.asarray(mask).astype(bool)
    idx = np.arange(H * W).reshape(H, W)
    valid_idx = np.where(m, idx, 0)

    p00 = valid_idx[:-1, :-1].ravel()
    p10 = valid_idx[1:, :-1].ravel()
    p11 = valid_idx[1:, 1:].ravel()
    p01 = valid_idx[:-1, 1:].ravel()
    if is_back:
        tris = np.concatenate([
            np.stack([p00, p01, p10], axis=1),
            np.stack([p01, p11, p10], axis=1),
        ], axis=0)
    else:
        tris = np.concatenate([
            np.stack([p00, p10, p01], axis=1),
            np.stack([p01, p10, p11], axis=1),
        ], axis=0)
    # Keep faces whose three corners are all valid (index 0 marks invalid —
    # the reference relies on pixel 0 being background, as do our masks).
    keep = (tris[:, 0] * tris[:, 1] * tris[:, 2]) > 0
    tris = tris[keep]

    # Used-vertex compaction via a bitmap (O(HW)) instead of np.unique's
    # sort over the 6F face entries, and attribute gathering only for the
    # kept vertices.
    used = np.zeros(H * W, bool)
    used[tris.ravel()] = True
    vert_ids = np.flatnonzero(used)
    remap = np.empty(H * W, np.int64)
    remap[vert_ids] = np.arange(vert_ids.shape[0])
    faces = remap[tris]

    ys, xs = np.divmod(vert_ids, W)
    # float32 attribute block: at 1024^2 the two sheets carry ~1M x 30
    # attributes, and every downstream pass (stitch concat, rig gather) is
    # memory-bandwidth-bound — f64 doubles that for no accuracy need at
    # pixel scale.
    points = np.empty((vert_ids.shape[0], 6 + weights.shape[2]), np.float32)
    points[:, 0] = xs
    points[:, 1] = ys
    points[:, 2] = depth[ys, xs]
    points[:, 3:6] = color[ys, xs]
    points[:, 6:] = weights[ys, xs]
    return points, faces


def boundary_edges(faces: np.ndarray) -> np.ndarray:
    """Edges that belong to exactly one face -> (B, 2) vertex pairs (the C++
    helper: a sort of the undirected edge codes lo*V + hi and a scan for
    runs of one; the pairs come as (lo, hi) in code order)."""
    return geometry.boundary_edges_from_faces(faces)


def boundary_edges_reference(faces: np.ndarray) -> np.ndarray:
    """The plain version of :func:`boundary_edges` in numpy: the same set
    of edges, in face order and as the faces orient them."""
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    V = np.int64(f.max()) + 1 if f.size else np.int64(1)
    codes = np.minimum(e[:, 0], e[:, 1]) * V + np.maximum(e[:, 0], e[:, 1])
    _, inv, counts = np.unique(codes, return_inverse=True,
                               return_counts=True)
    return e[counts[inv] == 1]


def boundary_ring(faces: np.ndarray) -> np.ndarray:
    """Ordered outer boundary vertex loop.

    O(n) successor walk over the once-only edges (the reference's version
    np.deletes from the edge list every step — O(n^2) python,
    lib/Depth2Mesh_Bspline.py:196-234), in the C++ helper.
    """
    return geometry.boundary_ring_walk(boundary_edges(faces))


def boundary_ring_walk_reference(be: np.ndarray) -> np.ndarray:
    """The plain version of :func:`tpubody_torch.geometry.boundary_ring_walk`
    in Python."""
    succ: Dict[int, List[int]] = {}
    for a, b in be:
        succ.setdefault(int(a), []).append(int(b))
        succ.setdefault(int(b), []).append(int(a))

    start = int(be[0, 0])
    ring = [start]
    prev = -1
    cur = start
    for _ in range(be.shape[0] + 1):
        nxts = [v for v in succ[cur] if v != prev]
        if not nxts:
            break
        nxt = nxts[0]
        if nxt == start:
            break
        ring.append(nxt)
        prev, cur = cur, nxt
    return np.asarray(ring, np.int64)


def inner_ring(faces: np.ndarray, ring: np.ndarray,
               n_verts: int) -> np.ndarray:
    """For each consecutive boundary pair, the interior vertex they share
    (reference in_bound_verts_index, lib/Depth2Mesh_Bspline.py:236-250).

    Vectorized: a boundary edge belongs to exactly one face, whose third
    vertex IS the shared interior neighbor — located by binary search over
    the sorted face-edge codes (no python loop over all faces; this was
    the stitch stage's hotspot at 1024^2)."""
    f = np.asarray(faces, np.int64)
    n = ring.shape[0]
    V = np.int64(n_verts)

    # All face edges as sorted-pair codes, tagged with the opposite vertex.
    pairs = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    opp = np.concatenate([f[:, 2], f[:, 0], f[:, 1]], axis=0)
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    codes = lo * V + hi
    order = np.argsort(codes, kind="stable")
    codes_sorted = codes[order]
    opp_sorted = opp[order]

    a = ring
    b = np.roll(ring, -1)
    q = np.minimum(a, b) * V + np.maximum(a, b)
    idx = np.searchsorted(codes_sorted, q)
    idx = np.clip(idx, 0, codes_sorted.shape[0] - 1)
    found = codes_sorted[idx] == q
    out = np.where(found, opp_sorted[idx], a)
    return out.astype(np.int64)


def vertex_adjacency(faces: np.ndarray, n_verts: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR-ish adjacency: (indptr (N+1,), indices (E,)) of vertex neighbors."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]],
                        faces[:, [1, 0]], faces[:, [2, 1]], faces[:, [0, 2]]],
                       axis=0)
    e = np.unique(e, axis=0)
    order = np.argsort(e[:, 0], kind="stable")
    e = e[order]
    counts = np.bincount(e[:, 0], minlength=n_verts)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr.astype(np.int64), e[:, 1].astype(np.int64)
