"""Fragment-window triangle rasterizer in torch ops.

Port of ``tpubody.render.raster``: the oracle the tiled rasterizer
(``render/tiled_raster.py``) is held to, and the fallback of the video
path for faces wider than every tile-span class.

  Pass 1 — *coverage*: every face rasterizes a fixed WINDOW x WINDOW pixel
    footprint anchored at its bbox corner (all faces at once).  Candidate
    fragments pack (quantized depth, face id) into one int32 and
    scatter-min into a flat z-buffer (``scatter_reduce_`` with "amin";
    integer minimum, so the order of the atomics does not matter).

  Pass 2 — *shading*: per pixel, unpack the winning face id, gather its
    three vertices, recompute exact barycentrics at the pixel centre and
    interpolate a K-channel vertex-attribute matrix in one pass.

The functions take one frame, like ``tpubody``'s (which ``vmap``s them);
``vertex_normals`` also takes leading batch dimensions, since the video
path calls it on a block of frames.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

INT32_MAX = int(np.iinfo(np.int32).max)


class RasterOutput(NamedTuple):
    attrs: torch.Tensor    # (H, W, C) interpolated vertex attributes
    depth: torch.Tensor    # (H, W) interpolated depth (+inf where no hit)
    mask: torch.Tensor     # (H, W) bool coverage
    face_id: torch.Tensor  # (H, W) int32 winning face (-1 where no hit)
    bary: torch.Tensor     # (H, W, 3) barycentric coords of the winner


def _face_bits(n_faces: int) -> int:
    bits = 1
    while (1 << bits) < n_faces + 1:
        bits += 1
    return bits


def shift_key(dq: torch.Tensor, fb: int) -> torch.Tensor:
    """``dq << fb`` on int32 with wrap-around (the shift is taken on the
    64-bit value and the low 32 bits reinterpreted), as XLA's int32 shift
    and the CUDA kernel's unsigned shift give it."""
    wide = dq.to(torch.int64) << fb
    wide = ((wide + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return wide.to(torch.int32)


def rasterize(
    verts: torch.Tensor,     # (V, 3) screen space: x_pix, y_pix, depth
    faces: torch.Tensor,     # (F, 3) integer vertex indices
    attrs: torch.Tensor,     # (V, C) per-vertex attributes to interpolate
    height: int,
    width: int,
    window: int = 64,
    cull_backface: bool = False,
    depth_ascending: bool = True,
) -> RasterOutput:
    """Rasterize a triangle mesh with per-vertex attribute interpolation.

    ``window`` bounds the per-face pixel footprint; faces whose bbox exceeds
    it are clipped (choose window >= max expected face extent in pixels).
    ``depth_ascending=True`` keeps the smallest depth per pixel (camera
    looking down +z).
    """
    F = int(faces.shape[0])
    fb = _face_bits(F)
    depth_levels = 1 << (31 - fb)
    dev = verts.device

    xy = verts[:, :2]
    z = verts[:, 2]
    if not depth_ascending:
        z = -z

    tri = faces.to(torch.int64)
    p0, p1, p2 = xy[tri[:, 0]], xy[tri[:, 1]], xy[tri[:, 2]]     # (F, 2)
    z0, z1, z2 = z[tri[:, 0]], z[tri[:, 1]], z[tri[:, 2]]        # (F,)

    # Signed double area (2D cross product of edges).
    area = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - \
           (p2[:, 0] - p0[:, 0]) * (p1[:, 1] - p0[:, 1])
    face_ok = area > 1e-12 if cull_backface else area.abs() > 1e-12
    inv_area = torch.where(
        face_ok, 1.0 / torch.where(face_ok, area, torch.ones_like(area)),
        torch.zeros_like(area))

    # Window anchor: integer bbox corner per face, clamped into the screen
    # so the window always covers the visible part of faces whose bbox
    # extends offscreen.  With window >= max(height, width) the clamp
    # guarantees full visible coverage whatever the projected bbox size.
    bb_min = torch.floor(torch.minimum(torch.minimum(p0, p1), p2)
                         ).to(torch.int32)
    hi = torch.tensor([width - window, height - window], dtype=torch.int32,
                      device=dev)
    zero = torch.zeros_like(hi)
    bb_min = torch.maximum(torch.minimum(bb_min, torch.maximum(zero, hi)),
                           torch.minimum(zero, hi))

    # Candidate pixel lattice: (F, window, window).
    w_idx = torch.arange(window, dtype=torch.int32, device=dev)
    px = bb_min[:, None, None, 0] + w_idx[None, None, :]
    py = bb_min[:, None, None, 1] + w_idx[None, :, None]
    pcx = px.to(verts.dtype) + 0.5   # pixel centers
    pcy = py.to(verts.dtype) + 0.5

    def edge(ax, ay, bx, by):
        # cross(b - a, p - a) for all candidate pixels
        return ((bx - ax)[:, None, None] * (pcy - ay[:, None, None])
                - (pcx - ax[:, None, None]) * (by - ay)[:, None, None])

    ia = inv_area[:, None, None]
    w0 = edge(p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]) * ia
    w1 = edge(p2[:, 0], p2[:, 1], p0[:, 0], p0[:, 1]) * ia
    w2 = edge(p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1]) * ia

    eps = -1e-7
    inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
    inbounds = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    valid = inside & inbounds & face_ok[:, None, None]

    depth = (w0 * z0[:, None, None] + w1 * z1[:, None, None]
             + w2 * z2[:, None, None])

    # Normalize depth into the quantization range using the mesh z extent.
    zmin = z.min()
    zmax = z.max()
    dq = ((depth - zmin) / torch.clamp(zmax - zmin, min=1e-12)
          * (depth_levels - 1)).to(torch.int32)
    dq = torch.clamp(dq, 0, depth_levels - 1)

    fid = torch.arange(F, dtype=torch.int32, device=dev)[:, None, None]
    packed = shift_key(dq, fb) | fid
    packed = torch.where(valid, packed,
                         torch.full_like(packed, INT32_MAX))

    lin = (py * width + px).to(torch.int64)
    lin = torch.where(valid, lin,
                      torch.full_like(lin, height * width))  # spill slot

    zbuf = torch.full((height * width + 1,), INT32_MAX, dtype=torch.int32,
                      device=dev)
    zbuf.scatter_reduce_(0, lin.reshape(-1), packed.reshape(-1), "amin",
                         include_self=True)
    zbuf = zbuf[: height * width].reshape(height, width)

    return shade_from_zbuf(zbuf, verts, faces, attrs, height, width,
                           depth_ascending=depth_ascending)


def shade_from_zbuf(
    zbuf: torch.Tensor,      # (H, W) packed int32 (depth << fb | face)
    verts: torch.Tensor,     # (V, 3) screen space
    faces: torch.Tensor,     # (F, 3)
    attrs: torch.Tensor,     # (V, C)
    height: int,
    width: int,
    depth_ascending: bool = True,
) -> RasterOutput:
    """Pass 2: exact barycentric shading of each pixel's winning face."""
    F = int(faces.shape[0])
    fb = _face_bits(F)
    dev = verts.device
    tri = faces.to(torch.int64)
    xy = verts[:, :2]
    z = verts[:, 2]
    if not depth_ascending:
        z = -z

    flat = zbuf.reshape(-1)
    hit = flat != INT32_MAX
    win_face = torch.where(hit, flat & ((1 << fb) - 1),
                           torch.zeros_like(flat)).to(torch.int64)

    cols = torch.arange(width, dtype=torch.int32, device=dev)
    rows = torch.arange(height, dtype=torch.int32, device=dev)
    gx = cols[None, :].expand(height, width).reshape(-1).to(verts.dtype) + 0.5
    gy = rows[:, None].expand(height, width).reshape(-1).to(verts.dtype) + 0.5

    ftri = tri[win_face]                     # (HW, 3)
    q0, q1, q2 = xy[ftri[:, 0]], xy[ftri[:, 1]], xy[ftri[:, 2]]
    a = ((q1[:, 0] - q0[:, 0]) * (q2[:, 1] - q0[:, 1])
         - (q2[:, 0] - q0[:, 0]) * (q1[:, 1] - q0[:, 1]))
    inv_a = 1.0 / torch.where(a.abs() > 1e-12, a, torch.ones_like(a))

    def edge_px(ax, ay, bx, by):
        return (bx - ax) * (gy - ay) - (gx - ax) * (by - ay)

    b0 = edge_px(q1[:, 0], q1[:, 1], q2[:, 0], q2[:, 1]) * inv_a
    b1 = edge_px(q2[:, 0], q2[:, 1], q0[:, 0], q0[:, 1]) * inv_a
    b2 = 1.0 - b0 - b1
    bary = torch.stack([b0, b1, b2], dim=-1)
    bary = torch.clamp(bary, 0.0, 1.0)
    bary = bary / torch.clamp(bary.sum(-1, keepdim=True), min=1e-12)

    av = (attrs[ftri[:, 0]] * bary[:, 0:1]
          + attrs[ftri[:, 1]] * bary[:, 1:2]
          + attrs[ftri[:, 2]] * bary[:, 2:3])                  # (HW, C)

    zf = z[ftri[:, 0]] * bary[:, 0] + z[ftri[:, 1]] * bary[:, 1] \
        + z[ftri[:, 2]] * bary[:, 2]
    if not depth_ascending:
        zf = -zf

    hitf = hit.to(av.dtype)[:, None]
    inf = torch.full_like(zf, float("inf"))
    return RasterOutput(
        attrs=(av * hitf).reshape(height, width, -1),
        depth=torch.where(hit, zf, inf).reshape(height, width),
        mask=hit.reshape(height, width),
        face_id=torch.where(hit, win_face, torch.full_like(win_face, -1)
                            ).to(torch.int32).reshape(height, width),
        bary=(bary * hitf).reshape(height, width, 3),
    )


def merge_rasters(a: RasterOutput, b: RasterOutput,
                  b_face_offset: int = 0) -> RasterOutput:
    """Depth-composite two rasterizations of disjoint face sets."""
    b_wins = b.depth < a.depth
    m = b_wins[..., None]
    b_face = torch.where(b.face_id >= 0, b.face_id + b_face_offset,
                         torch.full_like(b.face_id, -1))
    return RasterOutput(
        attrs=torch.where(m, b.attrs, a.attrs),
        depth=torch.where(b_wins, b.depth, a.depth),
        mask=a.mask | b.mask,
        face_id=torch.where(b_wins, b_face, a.face_id),
        bary=torch.where(m, b.bary, a.bary),
    )


def split_faces_by_extent(
    verts_screen: np.ndarray, faces: np.ndarray, small_window: int,
    pad_multiple: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side face binning for :func:`rasterize_binned`.

    Splits faces into (small, large) by projected bbox extent; each subset
    is padded with degenerate (0,0,0) faces to a multiple of
    ``pad_multiple`` so the shapes are stable across frames.
    """
    v = np.asarray(verts_screen)[:, :2]
    f = np.asarray(faces)
    tri = v[f]
    ext = (tri.max(axis=1) - tri.min(axis=1)).max(axis=1)
    small = f[ext <= small_window - 2]
    large = f[ext > small_window - 2]

    def pad(x):
        n = max(((x.shape[0] + pad_multiple - 1) // pad_multiple)
                * pad_multiple, pad_multiple)
        out = np.zeros((n, 3), f.dtype)
        out[:x.shape[0]] = x
        return out

    return pad(small), pad(large)


def rasterize_binned(
    verts: torch.Tensor, small_faces: torch.Tensor,
    large_faces: torch.Tensor, attrs: torch.Tensor, height: int, width: int,
    small_window: int = 32, large_window: int = 256,
    depth_ascending: bool = True,
) -> RasterOutput:
    """Two-class rasterization: the many small faces use a tight window
    (fragment count is faces x window^2), the few large ones a big window;
    results depth-composite."""
    a = rasterize(verts, small_faces, attrs, height, width,
                  window=small_window, depth_ascending=depth_ascending)
    b = rasterize(verts, large_faces, attrs, height, width,
                  window=large_window, depth_ascending=depth_ascending)
    return merge_rasters(a, b, b_face_offset=int(small_faces.shape[0]))


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted per-vertex normals.  verts (..., V, 3), faces (F, 3).

    The face normals are summed with ``index_add_``, whose float atomics on
    a GPU are not ordered: the last bits can differ from run to run."""
    tri = faces.to(torch.int64)
    v0 = verts[..., tri[:, 0], :]
    v1 = verts[..., tri[:, 1], :]
    v2 = verts[..., tri[:, 2], :]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)   # area-weighted
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(-2, tri[:, k], fn)
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True),
                            min=1e-12)


def shade_lambert(
    raster: RasterOutput,
    normals_img: torch.Tensor,     # (H, W, 3) interpolated normals
    colors_img: torch.Tensor,      # (H, W, 3) interpolated vertex colors
    light_dir=(0.0, 0.0, -1.0),
    ambient: float = 0.35,
    background: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Simple Lambert shading for animation frames (open3d replacement,
    lib/model2video.py:226-309)."""
    L = torch.tensor(light_dir, dtype=colors_img.dtype,
                     device=colors_img.device)
    L = L / torch.linalg.norm(L)
    n = normals_img / torch.clamp(
        torch.linalg.norm(normals_img, dim=-1, keepdim=True), min=1e-12)
    diff = torch.clamp((n * L).sum(-1).abs(), 0.0, 1.0)
    shaded = colors_img * (ambient + (1.0 - ambient) * diff)[..., None]
    if background is not None:
        shaded = torch.where(raster.mask[..., None], shaded, background)
    return shaded
