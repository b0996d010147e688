"""HMR single-image inference (port of ``tpubody.pipelines.hmr_infer``).

Images -> HMR (ResNet-50 + IEF) -> SMPL LBS -> posed meshes and cameras;
``from_files`` reads, crops and normalises image files first (cv2).
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.image import ops as image_ops
from tpubody_torch.models import hmr as hmr_lib
from tpubody_torch.models import params as params_lib
from tpubody_torch.models import smpl as smpl_lib
from tpubody_torch.render import camera as camera_lib


class HMRInferenceResult(NamedTuple):
    verts: torch.Tensor      # (B, V, 3)
    rotmats: torch.Tensor    # (B, 24, 3, 3)
    shape: torch.Tensor      # (B, 10)
    cam: torch.Tensor        # (B, 3) weak perspective
    cam_t: torch.Tensor      # (B, 3) full translation


class HMRPredictor:
    """Holds the HMR module and the body model on one device."""

    def __init__(self,
                 smpl_model: Optional[params_lib.BodyModelParams] = None,
                 state_dict=None,
                 dtype: torch.dtype = torch.bfloat16,
                 focal_length: float = 5000.0,
                 img_size: Optional[int] = None,
                 device: DeviceLike = "cuda",
                 arch: str = "hmr_r50",
                 mean_params: Optional[np.ndarray] = None):
        """``state_dict``: this package's weights of the regressor (e.g.
        from ``hmr.from_flax_variables``); random weights when None.
        ``arch``: "hmr_r50" (HMR, 224^2 crops by default) or "hmr2_vith"
        (HMR 2.0, ``models/hmr2``, 256^2 crops and no other size).
        ``mean_params``: the regressor's start (144 + 10 + 3,); by default
        ``hmr.default_mean_params()`` for HMR and
        ``hmr.identity_mean_params()`` for HMR 2.0."""
        self.device = resolve(device)
        self.arch = arch
        if arch == "hmr2_vith":
            from tpubody_torch.models import hmr2 as hmr2_lib

            self.model = hmr2_lib.create_hmr2(mean_params, dtype=dtype,
                                              device=self.device)
            if img_size not in (None, self.model.image_size):
                raise ValueError(f"img_size={img_size}: HMR 2.0 takes "
                                 f"{self.model.image_size}^2 crops")
            img_size = self.model.image_size
        elif arch == "hmr_r50":
            self.model = hmr_lib.create_hmr(mean_params, dtype=dtype,
                                            device=self.device)
        else:
            raise ValueError(f"arch={arch!r}: expected 'hmr_r50' or "
                             f"'hmr2_vith'")
        if state_dict is None:
            print("WARNING: HMR running with RANDOM-INIT weights — load "
                  "a checkpoint (load_torch_checkpoint) for meaningful "
                  "predictions.", file=sys.stderr)
        else:
            self.model.load_state_dict(state_dict)
        # Prefer a real SMPL model over the synthetic stand-in.
        smpl = smpl_model or params_lib.load_or_synthetic(
            "smpl", n_joints=24, n_verts=6890, seed=0)
        self.smpl = smpl.to(self.device)
        self.focal_length = focal_length
        self.img_size = img_size or 224

    @torch.inference_mode()
    def __call__(self, images) -> HMRInferenceResult:
        """images: (B, img_size, img_size, 3) normalised float32."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        out = self.model(images)
        state = smpl_lib.forward_batch(
            self.smpl, out.rotmats, out.shape, None, pose_is_rotmat=True)
        cam_t = camera_lib.weak_perspective_translation(
            out.cam, self.focal_length, self.img_size)
        return HMRInferenceResult(
            verts=state.verts, rotmats=out.rotmats, shape=out.shape,
            cam=out.cam, cam_t=cam_t)

    def from_files(self, paths: Sequence[str],
                   centers=None, scales=None) -> HMRInferenceResult:
        """Read, crop (center-crop by default), normalise, and infer."""
        crops = []
        for i, p in enumerate(paths):
            img = image_ops.read_image(p)
            H, W = img.shape[:2]
            center = (centers[i] if centers is not None
                      else np.array([W / 2, H / 2]))
            scale = (scales[i] if scales is not None
                     else max(H, W) / 200.0)
            crops.append(image_ops.scale_and_crop(
                img, center, scale, self.img_size))
        batch = image_ops.normalize_for_hmr(np.stack(crops))
        return self(torch.as_tensor(batch, dtype=torch.float32))

    def load_torch_checkpoint(self, path: str) -> None:
        """Load a reference torch checkpoint: SPIN's HMR, or for HMR 2.0
        4D-Humans' (a Lightning checkpoint's ``state_dict``).  The file is
        unpickled: load only checkpoints from a trusted source."""
        sd = torch.load(path, map_location="cpu", weights_only=False)
        for key in ("model", "state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if self.arch == "hmr2_vith":
            from tpubody_torch.models import hmr2 as hmr2_lib

            hmr2_lib.load_reference_state_dict(self.model, sd)
        else:
            hmr_lib.load_reference_state_dict(self.model, sd)
