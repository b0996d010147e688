"""Offscreen mesh viewer: render snapshots of meshes/fits to PNG (port of
``tpubody.render.viewer``).

Capability parity with the reference's interactive viewers
(lib/Gen_SMPLH/mesh_viewer.py:26-97 pyrender MeshViewer): "viewing"
renders through the port's fragment rasterizer to image files.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.render import raster as raster_lib
from tpubody_torch.render import video as video_lib


def snapshot(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    size: int = 512,
    cam_t: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
    background: float = 1.0,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Render one shaded view of a mesh; returns (size, size, 3) in [0,1]
    and optionally writes a PNG."""
    dev = resolve(device)
    v = np.asarray(verts, np.float64)
    center = v.mean(axis=0)
    extent = float(np.abs(v - center).max())
    if cam_t is None:
        cam_t = np.array([0.0, 0.0, 3.5 * max(extent, 1e-6)])
    if colors is None:
        colors = np.full_like(v, 0.65)
    elif np.asarray(colors).max() > 1.0 + 1e-6:
        colors = np.asarray(colors) / 255.0

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    bg = torch.full((size, size, 3), background, device=dev)
    img = video_lib.render_frame(
        t(v - center), t(faces, torch.int64), t(colors), t(cam_t), bg,
        height=size, width=size, focal=float(size))   # ~53 deg fov
    out = img.cpu().numpy()
    if out_path:
        from tpubody_torch.image import ops
        ops.write_image(out_path, out)
    return out


def overlay_fit(
    image: np.ndarray,            # (H, W, 3) photo
    verts: np.ndarray,
    faces: np.ndarray,
    camera_transl: np.ndarray,
    camera_center: np.ndarray,
    focal: float = 5000.0,
    alpha: float = 0.6,
    out_path: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Blend the rendered fit over the photo (the smplh2rgb_rend.png
    overlay artifact, fit_single_frame.py:470-521)."""
    from tpubody_torch.render import bodymaps
    dev = resolve(device)
    H, W = np.asarray(image).shape[:2]

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    v = t(verts)
    f = t(faces, torch.int64)
    screen = bodymaps.project_to_screen(v, t(camera_transl),
                                        t(camera_center), focal)
    normals = raster_lib.vertex_normals(v, f)
    shade = torch.clamp(torch.abs(normals[:, 2:3]), 0.2, 1.0)
    colors = torch.cat([shade * 0.7, shade * 0.7, shade * 0.9], dim=1)
    out = raster_lib.rasterize(screen, f, colors, H, W, window=64)
    base = np.asarray(image, np.float64)
    if base.max() > 1.5:
        base = base / 255.0
    rendered = out.attrs.cpu().numpy()
    mask = out.mask.cpu().numpy()[..., None]
    blended = np.where(mask, (1 - alpha) * base + alpha * rendered, base)
    if out_path:
        from tpubody_torch.image import ops
        ops.write_image(out_path, blended)
    return blended
