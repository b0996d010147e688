"""Motion-sequence readers: AMASS (.npz) and Mixamo (result.pkl).

Numpy-only copy of ``tpubody.io.motion`` (the port imports nothing of
``tpubody``); both packages read and write the same files.

Format parity with the reference readers:
  * AMASS (lib/model2video.py:527-531): npz with ``poses (T, 156)`` — the
    first 72 values are the 24-joint body pose — and ``trans (T, 3)``,
    root-normalized to the first frame.
  * Mixamo (lib/model2video_miaxmo.py:544-550): pickle with
    ``smpl_array (T, 24, 3)``, ``cam_array (T, 3)``, ``anim_len``, ``fps``.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np


class MotionClip(NamedTuple):
    poses: np.ndarray   # (T, 24, 3) axis-angle
    trans: np.ndarray   # (T, 3) root translation (zeros if absent)
    fps: float


def smplh156_to_smpl24(pose156: np.ndarray) -> np.ndarray:
    """(T, 156) SMPLH pose -> (T, 24, 3) SMPL body pose.

    SMPLH pose is [global 3][body 63 = joints 1..21][lhand 45][rhand 45];
    SMPL joints 22/23 (hands) have no SMPLH body counterpart and are set
    to zero.  The reference slices ``poses[:, :72]`` instead
    (model2video.py:527-531), which leaks the first two LEFT-hand finger
    rotations into joints 22/23 — harmless there only because its skinning
    ignores those joints (mesh2smpl_model.py:143); exporters without that
    mask (e.g. glTF) need the correct zeros.
    """
    pose156 = np.atleast_2d(np.asarray(pose156, np.float64))
    if pose156.shape[1] < 66:
        raise ValueError(
            f"need >= 66 pose values (global + 21 body joints), got "
            f"{pose156.shape[1]}")
    T = pose156.shape[0]
    return np.concatenate(
        [pose156[:, :66], np.zeros((T, 6))], axis=1).reshape(T, 24, 3)


def read_amass(path: str, stride: int = 1) -> MotionClip:
    z = np.load(path)
    raw = np.asarray(z["poses"], np.float64)
    if raw.shape[1] <= 72:
        # True SMPL-72 clip: joints 22/23 are real hand joints — keep them.
        poses = raw[:, :72].reshape(-1, 24, 3)
    else:
        # SMPLH (156) / SMPL-X (165): body is [:66], the rest is fingers.
        poses = smplh156_to_smpl24(raw[:, :66 + 90])
    if "trans" in z:
        trans = np.asarray(z["trans"], np.float64)
        trans = trans - trans[0]
    else:
        trans = np.zeros((poses.shape[0], 3))
    fps = float(np.asarray(z["mocap_framerate"]).reshape(-1)[0]) \
        if "mocap_framerate" in z else 60.0
    return MotionClip(poses=poses[::stride], trans=trans[::stride], fps=fps)


def read_mixamo(path: str, stride: int = 1) -> MotionClip:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="iso-8859-1")
    poses = np.asarray(d["smpl_array"], np.float64).reshape(-1, 24, 3)
    n = int(d.get("anim_len", poses.shape[0]))
    poses = poses[:n]
    # Mixamo clips carry camera, not root translation (the reference renders
    # them without trans, model2video_miaxmo.py:524-533).
    trans = np.zeros((poses.shape[0], 3))
    fps = float(d.get("fps", 30.0))
    return MotionClip(poses=poses[::stride], trans=trans[::stride], fps=fps)


def save_mixamo(path: str, poses: np.ndarray, cam: np.ndarray = None,
                fps: float = 30.0) -> None:
    poses = np.asarray(poses)
    with open(path, "wb") as f:
        pickle.dump({
            "smpl_array": poses,
            "cam_array": cam if cam is not None
            else np.zeros((poses.shape[0], 3)),
            "anim_len": poses.shape[0],
            "fps": fps,
        }, f)
