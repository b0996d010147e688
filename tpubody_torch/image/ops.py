"""Image file IO, HMR preprocessing and keypoint overlays on the host
(port of the IO, crop/normalise and drawing parts of
``tpubody.image.ops``).

``read_image`` / ``write_image`` / ``draw_keypoints`` go through cv2,
imported at first use.

``scale_and_crop`` resizes with ``torch.nn.functional.interpolate``
(bilinear, half-pixel centres, no antialiasing), the same sampling as the
JAX package's default host path, ``cv2.resize(..., INTER_LINEAR)`` on
float32 input.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def read_image(path: str, rgb: bool = True) -> np.ndarray:
    """Read an image file -> (H, W, 3) uint8 (RGB by default)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1].copy() if rgb else img


def write_image(path: str, img: np.ndarray, rgb: bool = True) -> None:
    """Write (H, W, 3) uint8, or float in [0, 1], to an image file."""
    import cv2
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    cv2.imwrite(path, a[:, :, ::-1] if (rgb and a.ndim == 3) else a)


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


def draw_keypoints(img: np.ndarray, keypoints: np.ndarray,
                   radius: int = 3, color=(255, 0, 0),
                   skeleton: Optional[Iterable[Tuple[int, int]]] = None,
                   ) -> np.ndarray:
    """Overlay keypoints (and optional skeleton bones) on an image
    (reference draw_key_point_in_image, utils/image_processing.py:1011)."""
    import cv2
    out = np.ascontiguousarray(np.asarray(img).copy())
    kp = np.asarray(keypoints)
    conf = kp[:, 2] if kp.shape[1] > 2 else np.ones(len(kp))
    for (x, y), c in zip(kp[:, :2], conf):
        if c > 0:
            cv2.circle(out, (int(round(x)), int(round(y))), radius,
                       color, -1)
    if skeleton is not None:
        for a, b in skeleton:
            if conf[a] > 0 and conf[b] > 0:
                cv2.line(out,
                         (int(round(kp[a, 0])), int(round(kp[a, 1]))),
                         (int(round(kp[b, 0])), int(round(kp[b, 1]))),
                         color, 1)
    return out


# OpenPose BODY_25 skeleton bone pairs for visualization.
BODY25_SKELETON = (
    (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8),
    (8, 9), (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (0, 15),
    (15, 17), (0, 16), (16, 18), (11, 22), (22, 23), (11, 24),
    (14, 19), (19, 20), (14, 21),
)
