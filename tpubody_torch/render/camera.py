"""Camera models (port of ``tpubody.render.camera``; so far only the HMR
weak-perspective camera)."""
from __future__ import annotations

import torch


def weak_perspective_translation(
    cam: torch.Tensor, focal_length: float, img_size: float
) -> torch.Tensor:
    """HMR weak-perspective (s, tx, ty) -> full translation (tx, ty, tz)
    with tz = 2f / (img_size * s) (the HMR/SPIN convention)."""
    s = torch.clamp(cam[..., 0], min=1e-6)
    tz = 2.0 * focal_length / (img_size * s)
    return torch.stack([cam[..., 1], cam[..., 2], tz], dim=-1)
