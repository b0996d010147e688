"""Rigged avatars: rigging a reconstruction onto the SMPL skeleton, the
container, animation through LBS, and checkpoints (port of
``tpubody.mesh.rigging``).

Capability parity with the reference RecoverModel
(lib/mesh2smpl_model.py:131-314):

  1. bbox-scale + root-translate the reconstructed mesh onto the posed SMPL
     (``align_mesh_to_smpl`` — reference mesh_verts_align :226-266, kept in
     float64),
  2. estimate the pose carrying the SMPL skeleton onto the reconstructed
     joints (:func:`tpubody_torch.core.skeleton.estimate_repose`),
  3. inverse-LBS the mesh to T-pose on the host in float64
     (``inverse_lbs_np``: the closed-form adjugate inverse of the blended
     transforms), with the SMPL forwards that feed it run in float32 on
     the model's device (:func:`tpubody_torch.models.smpl.forward`), as
     ``tpubody`` runs them,
  4. the rigged avatar then animates through ``core.lbs.skin_batch`` with
     joints ``IGNORED_JOINTS`` pose-zeroed (:143).

:class:`RiggedAvatar` has ``tpubody``'s field names and order;
``save_avatar`` / ``load_avatar`` use the reference's pickle schema
(save_model, lib/mesh2smpl_model.py:377-385), so either package reads what
the other wrote.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubody_torch.core import lbs as lbs_lib
from tpubody_torch.core import skeleton as skeleton_lib
from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.models import params as params_lib
from tpubody_torch.models import smpl as smpl_lib

# Pose of these joints is zeroed during animation (chest + hands,
# lib/mesh2smpl_model.py:143,272-274).
IGNORED_JOINTS = (13, 14, 22, 23)


class RiggedAvatar(NamedTuple):
    v_template: np.ndarray   # (V, 3) T-pose vertices
    weights: np.ndarray      # (V, 24) normalized skinning weights
    color: np.ndarray        # (V, 3)
    faces: np.ndarray        # (F, 3)
    joints: np.ndarray       # (24, 3) T-pose joints
    parents: Tuple[int, ...]
    or_pose: np.ndarray      # (24, 3) repose estimate (original pose)
    or_shape: np.ndarray     # (10,)


def avatar_from_numpy(v_template, weights, color, faces, joints,
                      parents: Sequence[int], or_pose=None,
                      or_shape=None) -> RiggedAvatar:
    """A :class:`RiggedAvatar` from the same numpy arrays that build
    ``tpubody.mesh.rigging.RiggedAvatar`` (float64 geometry, int64 faces;
    ``or_pose`` / ``or_shape`` default to zeros)."""
    joints = np.asarray(joints, np.float64)
    J = joints.shape[0]
    return RiggedAvatar(
        v_template=np.asarray(v_template, np.float64),
        weights=np.asarray(weights, np.float64),
        color=np.asarray(color),
        faces=np.asarray(faces, np.int64),
        joints=joints,
        parents=tuple(int(p) for p in parents),
        or_pose=(np.zeros((J, 3)) if or_pose is None
                 else np.asarray(or_pose)),
        or_shape=(np.zeros(10) if or_shape is None
                  else np.asarray(or_shape)),
    )


def align_mesh_to_smpl(
    smpl_verts: np.ndarray, verts: np.ndarray,
    smpl_joints: np.ndarray, joints3d: np.ndarray, eps: float = 1e-8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scale/translate the reconstruction into SMPL space: the mean of the
    x/y bbox ratios scales everything about the root joint, which is then
    moved onto the SMPL root (reference mesh_verts_align,
    lib/mesh2smpl_model.py:226-266)."""
    sv = np.asarray(smpl_verts, np.float64)
    v = np.asarray(verts, np.float64)
    J = np.asarray(joints3d, np.float64)
    sJ = np.asarray(smpl_joints, np.float64)

    d1 = sv[:, 0].max() - sv[:, 0].min()
    w1 = sv[:, 1].max() - sv[:, 1].min()
    d2 = v[:, 0].max() - v[:, 0].min()
    w2 = v[:, 1].max() - v[:, 1].min()
    s = ((d1 / d2 + eps) + (w1 / w2 + eps)) / 2.0

    v = (v - J[0]) * s + sJ[0]
    J = (J - J[0]) * s + sJ[0]
    return v, J


def inverse_lbs_np(verts: np.ndarray, weights: np.ndarray,
                   G_rel: np.ndarray) -> np.ndarray:
    """Host (numpy, f64) inverse LBS — the closed form of
    ``core.lbs.inverse_lbs`` (blend -> adjugate inverse -> apply).  It runs
    on the host because the mesh crosses from the host here and the
    (V, 24) @ (24, 16) product is small next to moving a million-vertex
    weight block to the card and back."""
    G = np.asarray(G_rel, np.float64).reshape(-1, 16)
    T = (np.asarray(weights, np.float64) @ G).reshape(-1, 4, 4)
    M, t = T[:, :3, :3], T[:, :3, 3]
    c0, c1, c2 = M[:, :, 0], M[:, :, 1], M[:, :, 2]
    r0 = np.cross(c1, c2)
    r1 = np.cross(c2, c0)
    r2 = np.cross(c0, c1)
    det = np.einsum("vi,vi->v", c0, r0)[:, None]
    v = np.asarray(verts, np.float64) - t
    return np.stack([np.einsum("vi,vi->v", r0, v),
                     np.einsum("vi,vi->v", r1, v),
                     np.einsum("vi,vi->v", r2, v)], axis=1) / det


def rig_mesh(
    model: params_lib.BodyModelParams,   # SMPL (24-joint) model
    verts: np.ndarray,                   # (V, 3) reconstructed mesh
    color: np.ndarray,                   # (V, 3)
    faces: np.ndarray,                   # (F, 3)
    weights: np.ndarray,                 # (V, 24) rasterized skinning weights
    pose: np.ndarray,                    # (24, 3) fitted body pose
    shape: np.ndarray,                   # (10,)
    joints3d: np.ndarray,                # (24, 3) recovered 3D joints
) -> RiggedAvatar:
    """Build a rigged, animatable avatar from the stitched reconstruction.
    The three SMPL forwards and the joints' affine inverse run in float32
    on the model's device; the rest in float64 on the host."""
    dev = model.device
    pose = np.asarray(pose, np.float64)[:24]
    shape = np.asarray(shape, np.float64)[:10]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    # Posed SMPL = the alignment target (main.py poses the model first).
    posed = smpl_lib.forward(model, f32(pose), f32(shape))
    aligned_verts, aligned_J = align_mesh_to_smpl(
        posed.verts.cpu().numpy(), verts, posed.joints_posed.cpu().numpy(),
        joints3d)

    # Zero-pose (shaped) SMPL joints = repose reference skeleton.
    rest = smpl_lib.forward(model, f32(np.zeros((24, 3))), f32(shape))
    rest_J = rest.joints_rest.cpu().numpy().astype(np.float64)

    or_pose = skeleton_lib.estimate_repose(
        rest_J, aligned_J, pose, model.parents)

    w = np.asarray(weights, np.float64)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)

    # Inverse-LBS to T-pose: pose the SMPL skeleton with or_pose, invert the
    # per-vertex blend transforms on the host in float64.
    state = smpl_lib.forward(model, f32(or_pose), f32(shape))
    G_rel = state.rel_transforms.cpu().numpy().astype(np.float64)
    v_template = inverse_lbs_np(aligned_verts, w, G_rel)

    # T-pose joints: G^-1 applied joint-wise (reference to_T_pose :205-207).
    Ginv = lbs_lib.affine_inverse(f32(G_rel)).cpu().numpy().astype(
        np.float64)
    J_t = np.einsum("jab,jb->ja", Ginv[:, :3, :3], aligned_J) + Ginv[:, :3, 3]

    return RiggedAvatar(
        v_template=v_template.astype(np.float64),
        weights=w,
        color=np.asarray(color, np.float64),
        faces=np.asarray(faces, np.int64),
        joints=J_t,
        parents=tuple(model.parents),
        or_pose=or_pose,
        or_shape=shape,
    )


def animate(avatar: RiggedAvatar, poses: np.ndarray,
            trans: Optional[np.ndarray] = None,
            device: DeviceLike = "cuda") -> torch.Tensor:
    """Skin the avatar for F frames in one batched pass -> (F, V, 3)
    float32 on ``device``.

    poses (F, 24, 3); joints in IGNORED_JOINTS are pose-zeroed
    (lib/mesh2smpl_model.py:272-274).
    """
    dev = resolve(device)
    p = np.asarray(poses, np.float32).copy()
    p[:, list(IGNORED_JOINTS), :] = 0.0

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return lbs_lib.skin_batch(
        f32(avatar.v_template), f32(avatar.weights), f32(avatar.joints),
        avatar.parents, f32(p), f32(trans) if trans is not None else None)


def save_avatar(path: str, avatar: RiggedAvatar) -> None:
    """Pickle with the reference's checkpoint schema (save_model,
    lib/mesh2smpl_model.py:377-385)."""
    J = len(avatar.parents)
    kintree = np.stack([np.asarray(avatar.parents), np.arange(J)])
    params = {
        "or_pose": avatar.or_pose,
        "weights": avatar.weights,
        "v_template": avatar.v_template,
        "color": avatar.color,
        "f": avatar.faces,
        "kintree_table": kintree,
        "parent": {i: avatar.parents[i] for i in range(1, J)},
        "J": avatar.joints,
    }
    with open(path, "wb") as f:
        pickle.dump(params, f)


def load_avatar(path: str) -> RiggedAvatar:
    """Load an avatar pickle written by either package or by the
    reference (lib/model2video.py:15-26 schema)."""
    with open(path, "rb") as f:
        p = pickle.load(f, encoding="iso-8859-1")
    parent_map = p["parent"]
    J = p["J"].shape[0]
    parents = [-1] * J
    for child, par in parent_map.items():
        parents[int(child)] = int(par)
    return RiggedAvatar(
        v_template=np.asarray(p["v_template"], np.float64),
        weights=np.asarray(p["weights"], np.float64),
        color=np.asarray(p.get("color", np.zeros_like(p["v_template"]))),
        faces=np.asarray(p["f"], np.int64),
        joints=np.asarray(p["J"], np.float64),
        parents=tuple(parents),
        or_pose=np.asarray(p.get("or_pose", np.zeros((J, 3)))),
        or_shape=np.asarray(p.get("or_shape", np.zeros(10))),
    )
