"""Mesh-triangle self-interpenetration penalty (cone distance field), port
of ``tpubody.fit.mesh_collision``.

Capability parity with the reference's BVH collision term
(lib/Gen_SMPLH/fitting.py:404-442: ``search_tree(triangles)`` finds
colliding triangle pairs with a CUDA BVH, ``tri_filtering_module`` drops
pairs from touching body parts, ``pen_distance`` penalizes with a conical
distance field around each triangle; knobs ``df_cone_height`` /
``penalize_outside`` / ``max_collisions`` in smpl_config.py:150-176),
re-designed TPU-first:

There is no BVH and no dynamic pair list.  Detection and penalty merge
into ONE dense masked computation: every statically-allowed
(triangle, vertex) pair gets a differentiable cone-penetration depth, and
the hinge zeroes the non-colliding pairs.  On TPU the FLOPs of the dense
sweep are cheap — both distance components reduce to (F,3)x(3,S) matmuls
on the MXU — while the data-dependent control flow a BVH needs is
expensive.  Static shapes, fully differentiable, jits into the same
L-BFGS program as the rest of the SMPLify loss.

Per pair (triangle i, vertex v):

    sd  = n_i . (v - c_i)            signed height over the face plane
    r   = | (v - c_i) - sd n_i |     in-plane radial distance
    pen = relu(-sd) * relu(1 - r / (cone_scale * R_i))

i.e. a cone of apex-depth ``df_cone_height``-like extent under the face
(axis -n_i, base radius ~ the triangle circumradius R_i).  The loss is
``sum pen^2`` over allowed pairs — the same shape as the reference's
distance-field penalty, without ``penalize_outside`` (pairs in front of
the face never penalize: tpubody fitting only ever uses the inside term).

Pair filtering mirrors ``fit.collision``: pairs whose dominant skinning
joints are identical or adjacent in the kinematic tree are excluded (the
reference's part-segmentation filter), and any pair already penetrating
at rest pose — legitimate surface neighbours — is masked out.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpubody_torch.fit.collision import _adjacency, _dominant_joint, _on


class MeshCollisionProxy(NamedTuple):
    face_vids: np.ndarray   # (F, 3) int32 — vertex ids of sampled faces
    vertex_idx: np.ndarray  # (S,) int32 — sampled vertex ids
    allowed: np.ndarray     # (F, S) bool — pairs that may be penalized
    cone_scale: float       # base-radius multiplier (df_cone_height analog)


def _tri_frame(verts: torch.Tensor, face_vids) -> tuple:
    """Per-face centroid, unit normal, circumradius. ``verts`` (..., V, 3)."""
    tri = verts[..., _on(face_vids, verts.device, torch.int64), :]
    c = torch.mean(tri, dim=-2)                      # (..., F, 3)
    n = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                           tri[..., 2, :] - tri[..., 0, :], dim=-1)
    # rsqrt(|n|^2 + eps), NOT norm(): a degenerate face (repeated vertex)
    # yields an exactly-zero cross product, where norm()'s gradient is
    # 0/0 = NaN.  The eps form is finite-valued AND finite-gradient.
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-24)
    R = torch.amax(torch.sqrt(
        torch.sum((tri - c[..., None, :]) ** 2, dim=-1) + 1e-24), dim=-1)
    return c, n, R


def penetration_depths(verts: torch.Tensor,
                       proxy: MeshCollisionProxy) -> torch.Tensor:
    """(..., F, S) cone-penetration depths (>=0), unmasked.  Both
    reductions are (F,3)x(3,S) matmuls; no (F,S,3) intermediate."""
    c, n, R = _tri_frame(verts, proxy.face_vids)
    pts = verts[..., _on(proxy.vertex_idx, verts.device, torch.int64), :]
    ptsT = pts.transpose(-1, -2)
    nv = torch.matmul(n, ptsT)                       # (..., F, S) n_i . v
    sd = nv - torch.sum(n * c, dim=-1)[..., :, None]  # signed height
    cv = torch.matmul(c, ptsT)                       # (..., F, S) c_i . v
    d2 = (torch.sum(pts ** 2, dim=-1)[..., None, :]
          - 2.0 * cv + torch.sum(c ** 2, dim=-1)[..., :, None])
    r = torch.sqrt(torch.clamp(d2 - sd ** 2, min=1e-12))  # in-plane radius
    base = torch.clamp(proxy.cone_scale * R[..., :, None], min=1e-9)
    return torch.clamp(-sd, min=0.0) * torch.clamp(1.0 - r / base, min=0.0)


def build_mesh_collision(
    v_template: np.ndarray,   # (V, 3) rest vertices
    faces: np.ndarray,        # (Ftot, 3) int
    weights: np.ndarray,      # (V, J) skinning weights
    parents: np.ndarray,      # (J,)
    n_faces: int = 2048,
    n_verts: int = 1024,
    cone_scale: float = 2.0,
) -> MeshCollisionProxy:
    """Precompute (host, once per model) the masked triangle/vertex sets.

    Faces and vertices are strided-subsampled to keep the dense (F,S)
    sweep small; at the defaults it is ~2M pairs (= a 2048x1024 matmul
    pair, microseconds on the MXU).  ``cone_scale`` plays the role of the
    reference's ``df_cone_height`` (smpl_config.py:150-153): how far
    under the surface the repulsive field reaches, in circumradii.
    """
    v = np.asarray(v_template, np.float64)
    faces = np.asarray(faces, np.int64)
    part_v = _dominant_joint(weights)
    adj = _adjacency(np.asarray(parents))

    fstride = max(1, faces.shape[0] // n_faces)
    f_idx = np.arange(0, faces.shape[0], fstride)[:n_faces]
    face_vids = faces[f_idx]
    vstride = max(1, v.shape[0] // n_verts)
    vert_idx = np.arange(0, v.shape[0], vstride)[:n_verts]

    # part of a face = majority vote of its corners' dominant joints
    fp = part_v[face_vids]                             # (F, 3)
    face_part = np.where(fp[:, 1] == fp[:, 2], fp[:, 1], fp[:, 0])
    allowed = ~adj[face_part[:, None], part_v[vert_idx][None]]
    # a vertex never collides with a face it belongs to
    allowed &= ~np.any(face_vids[:, :, None] == vert_idx[None, None], axis=1)

    # rest pose must be penalty-free: evaluate the depths once at rest
    # (host numpy, float64) with a safety-inflated cone and mask out
    # anything already inside — legitimate surface neighbours, not
    # collisions.
    tri = v[face_vids]
    c = tri.mean(axis=1)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    R = np.linalg.norm(tri - c[:, None], axis=-1).max(axis=-1)
    pts = v[vert_idx]
    d = pts[None] - c[:, None]                        # (F, S, 3)
    sd = np.einsum("fd,fsd->fs", n, d)
    r = np.sqrt(np.maximum(np.sum(d * d, axis=-1) - sd ** 2, 1e-24))
    base = np.maximum(cone_scale * 1.25 * R[:, None], 1e-9)
    # strict: any pair registering at ALL inside the rest cone is a
    # surface neighbour, not a collision.  The probe cone is inflated
    # both radially (1.25x base) and in depth (1mm behind-the-plane
    # margin) so a truly-boundary pair can't flip to penalizing under
    # on-device fp32 drift.
    rest = np.maximum(-(sd - 1e-3), 0.0) * np.maximum(1.0 - r / base, 0.0)
    allowed &= ~(rest > 0.0)
    return MeshCollisionProxy(
        face_vids=face_vids.astype(np.int32),
        vertex_idx=vert_idx.astype(np.int32),
        allowed=allowed, cone_scale=float(cone_scale))


def to_device(proxy: MeshCollisionProxy, device) -> MeshCollisionProxy:
    """The proxy's tables as tensors on ``device``."""
    return proxy._replace(
        face_vids=_on(np.asarray(proxy.face_vids, np.int64), device),
        vertex_idx=_on(np.asarray(proxy.vertex_idx, np.int64), device),
        allowed=_on(np.asarray(proxy.allowed), device))


def mesh_penetration_loss(verts: torch.Tensor,
                          proxy: MeshCollisionProxy,
                          allowed: torch.Tensor = None) -> torch.Tensor:
    """Sum of squared cone-penetration depths over allowed pairs:
    ``verts`` (..., V, 3) -> (...,)."""
    pen = penetration_depths(verts, proxy)
    mask = _on(proxy.allowed if allowed is None else allowed, verts.device)
    return torch.sum(torch.where(mask, pen ** 2, torch.zeros_like(pen)),
                     dim=(-2, -1))
