"""Image file IO, HMR preprocessing and keypoint overlays on the host
(port of the IO, crop/normalise and drawing parts of
``tpubody.image.ops``).

``read_image`` / ``write_image`` / ``draw_keypoints`` go through cv2,
imported at first use.

``scale_and_crop`` resizes with ``torch.nn.functional.interpolate``
(bilinear, half-pixel centres, no antialiasing), the same sampling as the
JAX package's default host path, ``cv2.resize(..., INTER_LINEAR)`` on
float32 input; with ``host=False`` it resizes through
:func:`resize_image`, the counterpart of ``jax.image.resize`` (which
antialiases on each axis that shrinks), on the card.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpubody_torch.device import DeviceLike, resolve


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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5 (``jax.image``'s; torch's bicubic uses
    a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(
            x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0),
            1.0)
        return torch.where(x > radius, 0.0, out)
    return kernel


_RESIZE_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"),
                    _triangle),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}


def _resize_weights(in_size: int, out_size: int, kernel,
                    device: torch.device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of one axis, as
    ``jax.image.scale_and_translate`` computes them with antialiasing:
    the kernel widened by 1 / scale where the axis shrinks, each column
    normalised to sum 1, columns whose sample falls outside the input
    zeroed."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=f32,
                                   device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=f32,
                                        device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_image(img, height: int, width: int, method: str = "linear",
                 device: DeviceLike = "cuda") -> torch.Tensor:
    """Resize (H, W, C) or (B, H, W, C), numpy or tensor, on ``device``:
    the counterpart of ``tpubody``'s ``resize_image``, which is
    ``jax.image.resize`` (antialiased where an axis shrinks).

    ``nearest`` picks ``floor((i + 0.5) * in / out)`` in float32 and keeps
    the dtype; the other methods (``linear``/``bilinear``/``triangle``,
    ``cubic``/``bicubic``, ``lanczos3``, ``lanczos5``) contract each axis
    whose size changes with :func:`_resize_weights` and return a floating
    tensor (float32 for integer input)."""
    dev = resolve(device)
    x = torch.as_tensor(img, device=dev)
    if x.ndim not in (3, 4):
        raise ValueError(f"image of shape {tuple(x.shape)}: (H, W, C) or "
                         f"(B, H, W, C)")
    h_dim = x.ndim - 3
    sizes = ((h_dim, height), (h_dim + 1, width))
    if method == "nearest":
        for d, n in sizes:
            m = int(x.shape[d])
            if m != n:
                idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                                device=dev) + 0.5) * m / n)
                x = x.index_select(d, idx.to(torch.int64))
        return x
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    kernel = _RESIZE_KERNELS[method]
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d, n in sizes:
        m = int(x.shape[d])
        if m != n:
            w = _resize_weights(m, n, kernel, dev).to(x.dtype)
            x = torch.tensordot(x.movedim(d, -1), w, dims=1).movedim(-1, d)
    return x


def scale_and_crop(img: np.ndarray, center: Sequence[float],
                   scale: float, size: int = 224, host: bool = True,
                   device: DeviceLike = "cuda") -> np.ndarray:
    """Crop a square window of side ``scale*200`` around ``center`` (the
    HMR convention) with edge padding, then resize to ``size`` x ``size``
    -> (size, size, C) float32.

    ``host=True`` resizes on the host (bilinear, no antialiasing: cv2's
    ``INTER_LINEAR``); ``host=False`` resizes through
    :func:`resize_image` on ``device`` (antialiased where it shrinks, as
    ``tpubody``'s ``host=False``) and copies the result back."""
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
    if not host:
        out = resize_image(np.asarray(crop, np.float32), size, size,
                           device=device)
        return out.cpu().numpy()
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
