"""Rigged avatars: the container, animation through LBS, and checkpoints.

Port of the part of ``tpubody.mesh.rigging`` that the animation path
needs: :class:`RiggedAvatar` (same field names and order), ``animate``
(through :func:`tpubody_torch.core.lbs.skin_batch`, result left on the
device), and ``save_avatar`` / ``load_avatar`` in the reference's pickle
schema (save_model, lib/mesh2smpl_model.py:377-385), so either package
reads what the other wrote.

Not ported yet (they build an avatar from a reconstruction and need
``core/skeleton.py``): ``rig_mesh``, ``align_mesh_to_smpl``,
``inverse_lbs_np``.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubody_torch.core import lbs as lbs_lib
from tpubody_torch.device import DeviceLike, resolve

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
