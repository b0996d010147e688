"""HMR preprocessing on the host (port of the crop/normalise part of
``tpubody.image.ops``).

``scale_and_crop`` resizes with ``torch.nn.functional.interpolate``
(bilinear, half-pixel centres, no antialiasing), the same sampling as the
JAX package's default host path, ``cv2.resize(..., INTER_LINEAR)`` on
float32 input.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def scale_and_crop(img: np.ndarray, center: Sequence[float],
                   scale: float, size: int = 224) -> np.ndarray:
    """Crop a square window of side ``scale*200`` around ``center`` (the
    HMR convention) with edge padding, then resize to ``size`` x ``size``
    -> (size, size, C) float32."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    half = scale * 200.0 / 2.0
    cx, cy = float(center[0]), float(center[1])
    x0, x1 = int(round(cx - half)), int(round(cx + half))
    y0, y1 = int(round(cy - half)), int(round(cy + half))

    pad_x0, pad_y0 = max(0, -x0), max(0, -y0)
    pad_x1, pad_y1 = max(0, x1 - W), max(0, y1 - H)
    crop = img[max(0, y0):min(H, y1), max(0, x0):min(W, x1)]
    if any((pad_x0, pad_x1, pad_y0, pad_y1)):
        crop = np.pad(crop, ((pad_y0, pad_y1), (pad_x0, pad_x1), (0, 0)),
                      mode="edge")
    x = torch.from_numpy(np.ascontiguousarray(crop, np.float32))
    x = x.permute(2, 0, 1)[None]                       # (1, C, h, w)
    out = F.interpolate(x, size=(size, size), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def normalize_for_hmr(img: np.ndarray) -> np.ndarray:
    """uint8/float RGB -> ImageNet-normalised float32 (B?, H, W, 3)."""
    a = np.asarray(img, np.float32)
    if a.max() > 1.5:
        a = a / 255.0
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (a - mean) / std


def crop_from_keypoints(keypoints: np.ndarray,
                        margin: float = 1.2) -> Tuple[np.ndarray, float]:
    """(center, scale) of the person bbox from 2D keypoints with conf>0."""
    kp = np.asarray(keypoints)
    valid = kp[:, 2] > 0 if kp.shape[1] > 2 else np.ones(len(kp), bool)
    pts = kp[valid][:, :2]
    lo, hi = pts.min(0), pts.max(0)
    center = (lo + hi) / 2.0
    scale = margin * max(hi - lo) / 200.0
    return center, float(scale)
