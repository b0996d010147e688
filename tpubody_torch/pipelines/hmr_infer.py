"""HMR single-image inference (port of ``tpubody.pipelines.hmr_infer``).

Images -> HMR (ResNet-50 + IEF) -> SMPL LBS -> posed meshes and cameras.
Reading image files (``from_files``) waits for an image decoder in the
port.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch

from tpubody_torch.device import DeviceLike, resolve
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
                 img_size: int = 224,
                 device: DeviceLike = "cuda"):
        """``state_dict``: this package's HMR weights (e.g. from
        ``hmr.from_flax_variables``); random weights when None."""
        self.device = resolve(device)
        self.model = hmr_lib.create_hmr(dtype=dtype, device=self.device)
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
        self.img_size = img_size

    @torch.inference_mode()
    def __call__(self, images) -> HMRInferenceResult:
        """images: (B, 224, 224, 3) normalised float32."""
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

    def load_torch_checkpoint(self, path: str) -> None:
        """Load a reference torch HMR checkpoint.  The file is unpickled:
        load only checkpoints from a trusted source."""
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        hmr_lib.load_reference_state_dict(self.model, sd)
