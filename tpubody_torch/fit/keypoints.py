"""OpenPose keypoint IO and SMPLH <-> OpenPose joint correspondence (the
port's own copy of ``tpubody.fit.keypoints``, numpy only).

Capability parity with lib/openpose.py:43-84 (JSON reader: BODY_25 + 2x21
hand keypoints) and lib/Gen_SMPLH/data_parser.py:60-181 (joint permutation,
per-joint optimization weights with joints 1/9/12 ignored).
"""
from __future__ import annotations

import json
from typing import NamedTuple, Sequence, Tuple

import numpy as np

NUM_BODY25 = 25
NUM_HAND = 21
NUM_FACE_CONTOUR = 17

# Permutation mapping the 73 SMPLH+extra joints onto the OpenPose
# [body25, left-hand21, right-hand21] order (data_parser.py:160-181).
SMPLH_BODY_TO_OPENPOSE = np.array(
    [52, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     53, 54, 55, 56, 57, 58, 59, 60, 61, 62], np.int32)
SMPLH_LHAND_TO_OPENPOSE = np.array(
    [20, 34, 35, 36, 63, 22, 23, 24, 64, 25, 26, 27, 65, 31, 32, 33, 66,
     28, 29, 30, 67], np.int32)
SMPLH_RHAND_TO_OPENPOSE = np.array(
    [21, 49, 50, 51, 68, 37, 38, 39, 69, 40, 41, 42, 70, 46, 47, 48, 71,
     43, 44, 45, 72], np.int32)


# SMPL (24-joint, model_type='smpl'): 24 = nose extra joint, 25..34 the
# eye/ear/toe/heel extras appended after the base joints
# (reference util.py smpl_to_openpose :97-100; no hand mapping exists).
SMPL_BODY_TO_OPENPOSE = np.array(
    [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     25, 26, 27, 28, 29, 30, 31, 32, 33, 34], np.int32)


# SMPL-X (55-joint, model_type='smplx'): 55 model joints, extra surface
# joints at 55..75 (nose..heels, then fingertips), face landmarks from 76
# (reference util.py smpl_to_openpose :116-138).  Hand chains sit at
# 25-39 (left) / 40-54 (right) — shifted +3 vs SMPLH by jaw/leye/reye.
SMPLX_BODY_TO_OPENPOSE = np.array(
    [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     56, 57, 58, 59, 60, 61, 62, 63, 64, 65], np.int32)
SMPLX_LHAND_TO_OPENPOSE = np.array(
    [20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68, 34, 35, 36, 69,
     31, 32, 33, 70], np.int32)
SMPLX_RHAND_TO_OPENPOSE = np.array(
    [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73, 49, 50, 51, 74,
     46, 47, 48, 75], np.int32)


def smplh_to_openpose(use_hands: bool = True) -> np.ndarray:
    maps = [SMPLH_BODY_TO_OPENPOSE]
    if use_hands:
        maps += [SMPLH_LHAND_TO_OPENPOSE, SMPLH_RHAND_TO_OPENPOSE]
    return np.concatenate(maps)


def smpl_to_openpose() -> np.ndarray:
    """24-joint SMPL -> OpenPose BODY_25 permutation (body only)."""
    return SMPL_BODY_TO_OPENPOSE


def smplx_to_openpose(use_hands: bool = True, use_face: bool = False,
                      use_face_contour: bool = False) -> np.ndarray:
    """55-joint SMPL-X -> OpenPose permutation (reference util.py:116-138).
    Face landmarks are appended after the 76 body+extra joints in model
    order (static 51 then the 17-point contour), which already matches the
    target keypoint order, so the face mapping is an arange."""
    maps = [SMPLX_BODY_TO_OPENPOSE]
    if use_hands:
        maps += [SMPLX_LHAND_TO_OPENPOSE, SMPLX_RHAND_TO_OPENPOSE]
    if use_face:
        maps += [np.arange(76, 127 + NUM_FACE_CONTOUR * use_face_contour,
                           dtype=np.int32)]
    return np.concatenate(maps)


class Keypoints(NamedTuple):
    keypoints: np.ndarray   # (K, 3) pixel x, y, confidence
    use_hands: bool


NUM_FACE = 51        # FLAME-compatible landmarks after the 17-pt contour


def read_openpose_json(path: str, use_hands: bool = True,
                       person: int = 0, use_face: bool = False,
                       use_face_contour: bool = False) -> Keypoints:
    """Read one person's keypoints from an OpenPose JSON
    (data/tests/*/0_keypoints.json format: people[i].pose_keypoints_2d (75,),
    hand_{left,right}_keypoints_2d (63,)).

    ``use_face`` appends the 51 FLAME-compatible face landmarks (rows
    17..68 of face_keypoints_2d) and ``use_face_contour`` the 17 jawline
    points, matching the reference reader (lib/openpose.py:64-79).  The
    SMPL/SMPLH fit ignores face rows (no face joints to map them to);
    they are read for the SMPL-X-style JSON contract."""
    with open(path) as f:
        data = json.load(f)
    ppl = data["people"]
    p = ppl[person]
    body = np.asarray(p["pose_keypoints_2d"], np.float64).reshape(-1, 3)
    parts = [body[:NUM_BODY25]]
    if use_hands:
        for key in ("hand_left_keypoints_2d", "hand_right_keypoints_2d"):
            h = p.get(key, [0.0] * (NUM_HAND * 3))
            parts.append(np.asarray(h, np.float64).reshape(-1, 3)[:NUM_HAND])
    if use_face:
        face = np.asarray(p.get("face_keypoints_2d", []),
                          np.float64).reshape(-1, 3)
        # OpenPose emits an empty (or short) face block on frames where no
        # face is detected — pad with zero-confidence rows so the returned
        # keypoint count is constant across a sequence.
        if face.shape[0] < 17 + NUM_FACE:
            face = np.concatenate(
                [face, np.zeros((17 + NUM_FACE - face.shape[0], 3))])
        parts.append(face[17:17 + NUM_FACE])
        if use_face_contour:
            parts.append(face[:17])
    return Keypoints(keypoints=np.concatenate(parts, axis=0),
                     use_hands=use_hands)


def num_people(path: str) -> int:
    """How many people an OpenPose JSON carries (len of ``people``)."""
    with open(path) as f:
        return len(json.load(f)["people"])


def write_openpose_json(path: str, body: np.ndarray,
                        left_hand: np.ndarray = None,
                        right_hand: np.ndarray = None) -> None:
    """Write the OpenPose JSON format (the lib/openpose.py output contract —
    the pipeline input interface, SURVEY.md §2.2 'pyopenpose')."""
    person = {"pose_keypoints_2d":
              np.asarray(body, np.float64).reshape(-1).tolist()}
    if left_hand is not None:
        person["hand_left_keypoints_2d"] = \
            np.asarray(left_hand, np.float64).reshape(-1).tolist()
    if right_hand is not None:
        person["hand_right_keypoints_2d"] = \
            np.asarray(right_hand, np.float64).reshape(-1).tolist()
    with open(path, "w") as f:
        json.dump({"version": 1.3, "people": [person]}, f)


def joint_weights(
    joints_to_ign: Sequence[int] = (1, 9, 12),
    use_hands: bool = True,
    use_face: bool = False,
    use_face_contour: bool = False,
) -> np.ndarray:
    """Per-joint optimization weights: 1 everywhere, 0 for the ignored
    neck/hips (data_parser.py:98-108: num_joints + 2 extra when hands;
    face rows appended for SMPL-X fits)."""
    n = NUM_BODY25 + (2 * NUM_HAND if use_hands else 0) + \
        (NUM_FACE + NUM_FACE_CONTOUR * use_face_contour if use_face else 0)
    w = np.ones(n, np.float32)
    for j in joints_to_ign:
        if 0 <= j < n:
            w[j] = 0.0
    return w
