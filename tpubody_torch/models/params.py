"""Body-model parameter containers and loaders (port of
``tpubody.models.params``).

Three sources, as in the JAX package: the reference pickle format, an
``.npz`` cache, and a deterministic synthetic model.  The synthetic
generators are numpy and give bit-identical float64 arrays to
``tpubody``'s for the same seed; only the container holds torch tensors.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike

# SMPL (24-joint) kinematic tree: parents[i] for joint i; root = -1.
SMPL_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)

# SMPLH (52-joint) tree: body 22 + left hand 15 (wrist 20) + right hand 15
# (wrist 21).
SMPLH_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    # left hand (index, middle, pinky, ring, thumb chains of 3)
    20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
    # right hand
    21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50,
)

# SMPLX (55-joint) tree: body 22 + jaw/leye/reye under the head (15) +
# 2x15 hand chains under the wrists (20/21).
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    # jaw, left eye, right eye
    15, 15, 15,
    # left hand
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    # right hand
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)

SMPL_NUM_VERTS = 6890
SMPL_NUM_FACES = 13776
SMPLX_NUM_VERTS = 10475
NUM_FACE_LANDMARKS = 51      # static FLAME-compatible landmarks
NUM_FACE_CONTOUR = 17        # jawline contour landmarks

_TENSOR_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor",
                  "weights", "hands_components_l", "hands_components_r",
                  "hands_mean_l", "hands_mean_r", "expr_dirs")


def parents_for(n_joints: int):
    if n_joints == 24:
        return SMPL_PARENTS
    if n_joints == 52:
        return SMPLH_PARENTS
    if n_joints == 55:
        return SMPLX_PARENTS
    raise ValueError(f"unsupported joint count {n_joints} (24, 52 or 55)")


@dataclasses.dataclass(eq=False)
class BodyModelParams:
    """SMPL-family model tensors.

    ``parents`` is a static tuple (the kinematic tree drives a Python
    loop); ``faces`` and the landmark tables stay host-side numpy.
    ``cache`` holds per-model constants derived on first use (the fused
    LBS kernel's basis layouts); :meth:`to` starts a fresh one.
    """

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, S)
    posedirs: torch.Tensor     # (V, 3, 9*(J-1))
    j_regressor: torch.Tensor  # (J, V)
    weights: torch.Tensor      # (V, J)
    parents: Tuple[int, ...]
    faces: np.ndarray
    hands_components_l: Optional[torch.Tensor] = None
    hands_components_r: Optional[torch.Tensor] = None
    hands_mean_l: Optional[torch.Tensor] = None
    hands_mean_r: Optional[torch.Tensor] = None
    expr_dirs: Optional[torch.Tensor] = None
    lmk_faces_idx: Optional[np.ndarray] = None     # (51[+17],) int
    lmk_bary_coords: Optional[np.ndarray] = None   # (51[+17], 3)
    cache: Dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def num_expressions(self) -> int:
        return 0 if self.expr_dirs is None else self.expr_dirs.shape[-1]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def _map(self, fn) -> "BodyModelParams":
        changes = {k: fn(getattr(self, k)) for k in _TENSOR_FIELDS
                   if getattr(self, k) is not None}
        return dataclasses.replace(self, cache={}, **changes)

    def to(self, device: DeviceLike) -> "BodyModelParams":
        return self._map(lambda t: t.to(device))

    def astype(self, dtype: torch.dtype) -> "BodyModelParams":
        return self._map(lambda t: t.to(dtype))


def _densify(x) -> np.ndarray:
    """Convert scipy-sparse / chumpy / numpy inputs to dense float64 numpy."""
    if hasattr(x, "toarray"):  # scipy sparse
        x = x.toarray()
    if hasattr(x, "r"):  # chumpy
        x = np.asarray(x.r)
    return np.asarray(x, dtype=np.float64)


def _parents_from_kintree(kintree_table: np.ndarray) -> Tuple[int, ...]:
    """Parent indices from a 2xJ kintree table."""
    kt = np.asarray(kintree_table)
    id_to_col = {int(kt[1, i]): i for i in range(kt.shape[1])}
    parents = [-1]
    for i in range(1, kt.shape[1]):
        parents.append(id_to_col[int(kt[0, i])])
    return tuple(parents)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def load_pickle(path: str, dtype=torch.float32, num_betas: int = 10,
                num_expressions: int = 10,
                device: DeviceLike = "cpu") -> BodyModelParams:
    """Load a SMPL/SMPLH/SMPLX parameter pickle in the reference's on-disk
    format (SMPL-X packs shape and expression into one (V, 3, 400)
    ``shapedirs``, split per the smplx convention).  Unpickle only
    trusted model files: unpickling can run arbitrary code."""
    with open(path, "rb") as f:
        params = pickle.load(f, encoding="iso-8859-1")
    parents = _parents_from_kintree(params["kintree_table"])
    J = len(parents)
    posedirs = _densify(params["posedirs"]).reshape(-1, 3, 9 * (J - 1))
    shapedirs = _densify(params["shapedirs"])
    expr_dirs = None
    if shapedirs.shape[-1] > 300:       # smplx packed shape+expression
        expr_dirs = shapedirs[:, :, 300:300 + num_expressions]
        shapedirs = shapedirs[:, :, :num_betas]

    def opt(key, arr=None):
        arr = params.get(key) if arr is None else arr
        if arr is not None:
            return _tensor(_densify(arr), dtype, device)
        return None

    lmk_idx = params.get("lmk_faces_idx")
    lmk_bary = params.get("lmk_bary_coords")
    return BodyModelParams(
        v_template=_tensor(_densify(params["v_template"]), dtype, device),
        shapedirs=_tensor(shapedirs, dtype, device),
        posedirs=_tensor(posedirs, dtype, device),
        j_regressor=_tensor(_densify(params["J_regressor"]), dtype, device),
        weights=_tensor(_densify(params["weights"]), dtype, device),
        parents=parents,
        faces=np.asarray(params["f"], dtype=np.int32),
        hands_components_l=opt("hands_componentsl"),
        hands_components_r=opt("hands_componentsr"),
        hands_mean_l=opt("hands_meanl"),
        hands_mean_r=opt("hands_meanr"),
        expr_dirs=opt("expr_dirs", expr_dirs),
        lmk_faces_idx=(None if lmk_idx is None
                       else np.asarray(lmk_idx, np.int64)),
        lmk_bary_coords=(None if lmk_bary is None
                         else np.asarray(_densify(lmk_bary))),
    )


def load_npz(path: str, dtype=torch.float32,
             device: DeviceLike = "cpu") -> BodyModelParams:
    """Load the ``.npz`` cache written by ``tpubody``'s ``save_npz``."""
    z = np.load(path)

    def opt(key, as_np=False):
        if key not in z.files:
            return None
        if as_np:
            return np.asarray(z[key])
        return _tensor(z[key], dtype, device)

    return BodyModelParams(
        v_template=_tensor(z["v_template"], dtype, device),
        shapedirs=_tensor(z["shapedirs"], dtype, device),
        posedirs=_tensor(z["posedirs"], dtype, device),
        j_regressor=_tensor(z["j_regressor"], dtype, device),
        weights=_tensor(z["weights"], dtype, device),
        parents=tuple(int(p) for p in z["parents"]),
        faces=np.asarray(z["faces"], dtype=np.int32),
        hands_components_l=opt("hands_components_l"),
        hands_components_r=opt("hands_components_r"),
        hands_mean_l=opt("hands_mean_l"),
        hands_mean_r=opt("hands_mean_r"),
        expr_dirs=opt("expr_dirs"),
        lmk_faces_idx=opt("lmk_faces_idx", as_np=True),
        lmk_bary_coords=opt("lmk_bary_coords", as_np=True),
    )


def load(path: str, dtype=torch.float32,
         device: DeviceLike = "cpu") -> BodyModelParams:
    """Load from .npz or .pkl, whichever the extension says."""
    if path.endswith(".npz"):
        return load_npz(path, dtype, device=device)
    return load_pickle(path, dtype, device=device)


def _synthetic_numpy(
    n_joints: int,
    n_verts: int,
    n_betas: int,
    seed: int,
) -> dict:
    """Deterministic synthetic SMPL-like tensors (float64 numpy): a
    humanoid-ish point cloud around a random skeleton, with local
    skinning weights, a proximity joint regressor and small blendshapes.
    Same draws in the same order as ``tpubody``'s generator."""
    rng = np.random.default_rng(seed)
    parents = parents_for(n_joints)
    assert len(parents) == n_joints

    # Rest skeleton: root at origin, children offset in a repeatable pattern.
    joints = np.zeros((n_joints, 3))
    for i in range(1, n_joints):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        bone_len = 0.08 + 0.12 * rng.random()
        joints[i] = joints[parents[i]] + direction * bone_len

    # Vertices scattered around bones.
    owner = rng.integers(0, n_joints, size=n_verts)
    v_template = joints[owner] + rng.normal(scale=0.05, size=(n_verts, 3))

    # Skinning weights: softmax of negative distance to each joint (sharp).
    d = np.linalg.norm(v_template[:, None, :] - joints[None, :, :], axis=-1)
    logits = -d / 0.03
    logits -= logits.max(axis=1, keepdims=True)
    weights = np.exp(logits)
    weights /= weights.sum(axis=1, keepdims=True)

    # Joint regressor: normalized proximity weights (rows sum to 1).
    prox = np.exp(-d.T / 0.02)
    j_regressor = prox / prox.sum(axis=1, keepdims=True)

    shapedirs = rng.normal(scale=0.01, size=(n_verts, 3, n_betas))
    posedirs = rng.normal(scale=0.001, size=(n_verts, 3, 9 * (n_joints - 1)))

    # A valid (if arbitrary) triangulation over vertex indices.
    n_faces = 2 * n_verts - 4 if n_verts == SMPL_NUM_VERTS else n_verts
    faces = rng.integers(0, n_verts, size=(max(n_faces, 4), 3)).astype(np.int32)

    out = dict(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        weights=weights,
        parents=tuple(parents),
        faces=faces,
    )
    if n_joints == 55:           # SMPL-X: expression + face landmarks
        expr_dirs = rng.normal(scale=0.005, size=(n_verts, 3, 10))
        # Concentrate expression deformation on head-owned vertices.
        head_mask = (owner == 15) | (owner == 22) | (owner == 23) | \
            (owner == 24)
        expr_dirs[~head_mask] *= 0.01
        out["expr_dirs"] = expr_dirs
        idx, bary = face_landmark_embedding(v_template, faces, joints[15],
                                            jaw_center=joints[22])
        out["lmk_faces_idx"] = idx
        out["lmk_bary_coords"] = bary
    return out


def face_landmark_embedding(v_template: np.ndarray, faces: np.ndarray,
                            head_center: np.ndarray,
                            jaw_center: Optional[np.ndarray] = None):
    """Deterministic synthetic face-landmark embedding: rows 0-30 on
    forward-facing faces near the head, rows 31-50 and the 17 jawline
    rows on faces nearest the jaw.  Centroid barycentrics."""
    if jaw_center is None:
        jaw_center = head_center
    cent = v_template[np.asarray(faces)].mean(axis=1)

    def _pick(center, n, forward=0.0):
        score = -np.linalg.norm(cent - center, axis=1) + forward * cent[:, 2]
        order = np.argsort(-score)
        pool = order[:max(4 * n, n)]
        return pool[np.linspace(0, pool.shape[0] - 1, n).astype(int)]

    upper = _pick(head_center, 31, forward=0.5)       # brows/nose/eyes
    mouth = _pick(jaw_center, NUM_FACE_LANDMARKS - 31)  # mouth rows 31-50
    contour = _pick(jaw_center, NUM_FACE_CONTOUR)     # jawline
    sel = np.concatenate([upper, mouth, contour])
    bary = np.full((sel.shape[0], 3), 1.0 / 3.0)
    return sel.astype(np.int64), bary


def synthetic(
    n_joints: int = 24,
    n_verts: int = 862,
    n_betas: int = 10,
    seed: int = 0,
    dtype=torch.float32,
    device: DeviceLike = "cpu",
) -> BodyModelParams:
    """Deterministic synthetic body model (see :func:`_synthetic_numpy`)."""
    raw = _synthetic_numpy(n_joints, n_verts, n_betas, seed)
    return params_from_numpy(raw, dtype=dtype, device=device)


def params_from_numpy(raw: dict, dtype=torch.float32,
                      device: DeviceLike = "cpu") -> BodyModelParams:
    """BodyModelParams from a synthetic/humanoid numpy model dict."""
    return BodyModelParams(
        v_template=_tensor(raw["v_template"], dtype, device),
        shapedirs=_tensor(raw["shapedirs"], dtype, device),
        posedirs=_tensor(raw["posedirs"], dtype, device),
        j_regressor=_tensor(raw["j_regressor"], dtype, device),
        weights=_tensor(raw["weights"], dtype, device),
        parents=raw["parents"],
        faces=raw["faces"],
        expr_dirs=(_tensor(raw["expr_dirs"], dtype, device)
                   if "expr_dirs" in raw else None),
        lmk_faces_idx=raw.get("lmk_faces_idx"),
        lmk_bary_coords=raw.get("lmk_bary_coords"),
    )


def synthetic_numpy(
    n_joints: int = 24, n_verts: int = 862, n_betas: int = 10, seed: int = 0
) -> dict:
    """Raw float64 numpy synthetic model, for oracle-side use in tests."""
    return _synthetic_numpy(n_joints, n_verts, n_betas, seed)


def default_model_path(kind: str = "smpl",
                       gender: str = "neutral") -> Optional[str]:
    """A real model asset, if one is present: the package's ``assets``
    directory or the ``TPUBODY_<KIND>[_<GENDER>]_PATH`` environment
    variables (the same names ``tpubody`` reads)."""
    if gender not in ("neutral", "male", "female"):
        raise ValueError(f"gender={gender!r} (neutral, male or female)")
    assets = os.path.join(os.path.dirname(__file__), "assets")
    candidates = [
        os.path.join(assets, f"{kind}_{gender}.npz"),
        os.environ.get(f"TPUBODY_{kind.upper()}_{gender.upper()}_PATH", ""),
        os.path.join(assets, f"{kind}_neutral.npz"),
        os.environ.get("TPUBODY_" + kind.upper() + "_PATH", ""),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def load_or_synthetic(kind: str = "smpl", n_joints: int = 24,
                      n_verts: int = 6890, seed: int = 0,
                      warn: bool = True,
                      gender: str = "neutral",
                      device: DeviceLike = "cpu") -> BodyModelParams:
    """A real body model when one is installed, else a synthetic stand-in
    (the capsule humanoid, or the point-cloud blob for vertex budgets too
    small for it), with a warning: synthetic meshes are placeholders."""
    # Only a full-size request can be satisfied by a real asset.
    full_size = SMPLX_NUM_VERTS if kind == "smplx" else SMPL_NUM_VERTS
    path = default_model_path(kind, gender) if n_verts == full_size else None
    if path:
        return load(path, device=device)
    if warn:
        print(
            f"WARNING: no real {kind.upper()} model found "
            f"(set TPUBODY_{kind.upper()}_PATH or install "
            f"tpubody_torch/models/assets/{kind}_neutral.npz); using a "
            f"SYNTHETIC body — exported meshes are placeholders, not real "
            f"bodies.", file=sys.stderr)
    from tpubody_torch.models import humanoid as humanoid_lib

    try:
        return humanoid_lib.humanoid(n_joints=n_joints, n_verts=n_verts,
                                     seed=seed, device=device)
    except ValueError:
        return synthetic(n_joints=n_joints, n_verts=n_verts, seed=seed,
                         device=device)
