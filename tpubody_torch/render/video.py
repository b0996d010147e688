"""Shaded animation-frame rendering + MP4 muxing.

Port of ``tpubody.render.video``.  Same camera setup as the reference's
Open3D renderer (lib/model2video.py:226-309): 1024x1024 frames, pinhole
f=2500 centred, extrinsic flip of the y/z axes, the mesh pre-rotated by
-pi/2 about x per frame.  Frames are rasterized and Lambert-shaded on the
device: :func:`render_frames_tiled` through the fused tiled rasterizer
(``render/tiled_raster.py``), :func:`render_frames` through the fragment
rasterizer (``render/raster.py``).  H.264 muxing stays on the host via cv2.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubody_torch.render import raster as raster_lib
from tpubody_torch.render import tiled_raster as TR

DEFAULT_SIZE = 1024
DEFAULT_FOCAL = 2500.0

# Max fragments one large-face rasterize call may materialize PER FRAME.
FRAG_BUDGET = 12_000_000

# Rotate -pi/2 about x (the reference applies this to every frame's verts,
# lib/model2video.py:302-304).
_PRE_ROT = np.array([[1.0, 0, 0],
                     [0, 0.0, 1.0],
                     [0, -1.0, 0.0]])
# Extrinsic: flip y and z (open3d extrinsic diag(1,-1,-1), :286-289).
_FLIP_YZ = np.diag([1.0, -1.0, -1.0])

_LIGHT = (0.3, 0.3, -1.0)


class FrameCamera(NamedTuple):
    focal: float
    center: Tuple[float, float]
    cam_t: np.ndarray     # (3,) camera translation


def _to_camera(verts: torch.Tensor, cam_t: torch.Tensor) -> torch.Tensor:
    """Posed vertices (..., V, 3) -> camera space (pre-rotation, camera
    translation (3,) or (B, 3), y/z flip)."""
    pre = torch.as_tensor(_PRE_ROT.T, dtype=verts.dtype, device=verts.device)
    flip = torch.as_tensor(_FLIP_YZ.T, dtype=verts.dtype, device=verts.device)
    if cam_t.dim() == 2:
        cam_t = cam_t[:, None, :]
    return torch.matmul(torch.matmul(verts, pre) + cam_t, flip)


def _to_screen(v: torch.Tensor, height: int, width: int,
               focal: float) -> torch.Tensor:
    """Camera space -> screen space (x_pix, y_pix, depth).  After the flip
    the camera looks down -z; -z is the depth."""
    z = torch.clamp(-v[..., 2:3], min=1e-6)
    x = v[..., 0:1] / z * focal + width / 2.0
    y = -v[..., 1:2] / z * focal + height / 2.0
    return torch.cat([x, y, z], dim=-1)


def _unit_light(like: torch.Tensor) -> torch.Tensor:
    L = torch.tensor(_LIGHT, dtype=like.dtype, device=like.device)
    return L / torch.linalg.norm(L)


def render_frame(
    verts: torch.Tensor,        # (V, 3) posed vertices
    faces: torch.Tensor,        # (F, 3)
    colors: torch.Tensor,       # (V, 3) in [0,1]
    cam_t: torch.Tensor,        # (3,)
    background: torch.Tensor,   # (H, W, 3) in [0,1]
    height: int = DEFAULT_SIZE,
    width: int = DEFAULT_SIZE,
    focal: float = DEFAULT_FOCAL,
    window: int = 64,
) -> torch.Tensor:
    """Shade one frame through the fragment rasterizer: (H, W, 3) float in
    [0,1]."""
    v = _to_camera(verts, cam_t)
    screen = _to_screen(v, height, width, focal)
    normals = raster_lib.vertex_normals(v, faces)
    attrs = torch.cat([colors, normals], dim=-1)
    out = raster_lib.rasterize(screen, faces, attrs, height, width,
                               window=window)
    img = raster_lib.shade_lambert(out, out.attrs[..., 3:6],
                                   out.attrs[..., :3], light_dir=_LIGHT,
                                   background=background)
    return torch.clamp(img, 0.0, 1.0)


def render_frames(
    verts_seq: torch.Tensor,    # (F, V, 3)
    faces: torch.Tensor,
    colors: torch.Tensor,
    cam_t: torch.Tensor,        # (3,) or (F, 3)
    background: torch.Tensor,
    height: int = DEFAULT_SIZE,
    width: int = DEFAULT_SIZE,
    focal: float = DEFAULT_FOCAL,
    window: int = 64,
) -> torch.Tensor:
    """Render F frames through the fragment rasterizer, one after another
    (its faces x window^2 transients are per frame)."""
    return torch.stack([
        render_frame(verts_seq[i], faces, colors,
                     cam_t[i] if cam_t.dim() == 2 else cam_t, background,
                     height, width, focal, window)
        for i in range(int(verts_seq.shape[0]))])


def render_frame_binned(
    verts: torch.Tensor, small_faces: torch.Tensor,
    large_faces: torch.Tensor, all_faces: torch.Tensor,
    colors: torch.Tensor, cam_t: torch.Tensor, background: torch.Tensor,
    height: int = DEFAULT_SIZE, width: int = DEFAULT_SIZE,
    focal: float = DEFAULT_FOCAL,
    small_window: int = 32, large_window: int = 256,
) -> torch.Tensor:
    """render_frame with two-class face binning (raster.rasterize_binned):
    body meshes have a handful of large faces, so the dominant small class
    runs with a tight fragment window."""
    v = _to_camera(verts, cam_t)
    screen = _to_screen(v, height, width, focal)
    normals = raster_lib.vertex_normals(v, all_faces)
    attrs = torch.cat([colors, normals], dim=-1)
    out = raster_lib.rasterize_binned(
        screen, small_faces, large_faces, attrs, height, width,
        small_window=small_window, large_window=large_window)
    img = raster_lib.shade_lambert(
        out, out.attrs[..., 3:6], out.attrs[..., :3], light_dir=_LIGHT,
        background=background)
    return torch.clamp(img, 0.0, 1.0)


def _screen_and_attrs(verts_seq, all_faces, colors, cam_t, height, width,
                      focal, shading):
    """The tiled renderer's inputs for a block of posed frames (B, V, 3):
    screen-space vertices (B, V, 3) and the per-vertex attributes the
    kernel interpolates, (B, V, 3) pre-shaded colour for "gouraud" or
    (B, V, 6) colour + normal for "phong"."""
    if shading not in ("phong", "gouraud"):
        raise ValueError(f"unknown shading {shading!r}")
    v = _to_camera(verts_seq, cam_t)
    screen = _to_screen(v, height, width, focal)
    normals = raster_lib.vertex_normals(v, all_faces)
    colors_b = colors.expand(normals.shape)
    if shading == "gouraud":
        nn = normals / torch.clamp(
            torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)
        diff_v = torch.clamp(torch.matmul(nn, _unit_light(nn)).abs(),
                             0.0, 1.0)                     # (B, V)
        attrs = colors_b * (0.35 + 0.65 * diff_v)[..., None]
    else:
        attrs = torch.cat([colors_b, normals], dim=-1)
    return screen, attrs


def _composite(attr, mask, depth, attr2, mask2, depth2):
    """Depth-composite a second tiled pass over the first -> (attr, mask,
    depth)."""
    take = mask2 & (depth2 < depth)
    return (torch.where(take[:, None], attr2, attr), mask | mask2,
            torch.where(take, depth2, depth))


def render_frames_tiled(
    verts_seq: torch.Tensor,    # (B, V, 3) posed vertices
    small_faces: torch.Tensor,  # (Fs, 3) faces within the tile-span budget
    large_buckets,              # sequence of (Fl_i, 3) face tensors, or None
    all_faces: torch.Tensor,    # (F, 3) full topology (for vertex normals)
    colors: torch.Tensor,       # (V, 3)
    cam_t: torch.Tensor,
    background: torch.Tensor,   # (H, W, 3)
    height: int = DEFAULT_SIZE,
    width: int = DEFAULT_SIZE,
    focal: float = DEFAULT_FOCAL,
    max_chunks: int = 8,
    span_x: int = 2,
    span_y: int = 5,
    total_chunks: int = None,   # CSR chunk budget (plan_tiled_render)
    large_windows: Tuple[int, ...] = (),   # parallel to large_buckets
    ladder_faces: Sequence[torch.Tensor] = (),
    ladder_specs: Tuple[Tuple[int, ...], ...] = (),
    # ladder_specs entries: (span_x, span_y, max_chunks, total_chunks)
    to_uint8: bool = True,
    channel_major_out: bool = False,
    i420_out: bool = False,
    shading: str = "phong",
) -> torch.Tensor:
    """Batch-render frames through the fused tiled rasterizer.

    Faces whose projected extent exceeds the base span budget render
    through additional tiled passes with wider tile spans (the ladder:
    ``ladder_faces`` + ``ladder_specs``, sized by ``plan_tiled_render``)
    and depth-composite.  Only faces beyond the ladder's top rung still
    use the fragment path (``large_buckets``/``large_windows``).
    ``shading``: "phong" interpolates colour and normal (6 channels) and
    shades per pixel; "gouraud" shades per vertex and interpolates the
    shaded colour (3 channels).  Returns (B, H, W, 3) uint8 unless
    ``to_uint8=False``; (B, 3, H, W) with ``channel_major_out``; planar
    I420 (B, H*3//2, W) uint8 with ``i420_out``.  Nothing here
    synchronises with the host.
    """
    screen, attrs = _screen_and_attrs(verts_seq, all_faces, colors, cam_t,
                                      height, width, focal, shading)

    # Channel-major throughout: the kernel writes (B, C, H, W).
    attr, mask, depth, _ = TR.render_attrs_tiled(
        screen, small_faces, attrs, height, width,
        max_chunks=max_chunks, span_x=span_x, span_y=span_y,
        total_chunks=total_chunks, channel_major=True)

    for lf, spec in zip(ladder_faces or (), ladder_specs):
        sx2, sy2, nc2 = spec[:3]
        tc2 = spec[3] if len(spec) > 3 else None
        if int(lf.shape[0]) == 0:
            continue
        attr2, mask2, depth2, _ = TR.render_attrs_tiled(
            screen, lf, attrs, height, width,
            max_chunks=nc2, span_x=sx2, span_y=sy2, total_chunks=tc2,
            channel_major=True)
        attr, mask, depth = _composite(attr, mask, depth, attr2, mask2,
                                       depth2)

    for bf, bw in zip(large_buckets or (), large_windows):
        if int(bf.shape[0]) == 0:
            continue
        big = [raster_lib.rasterize(screen[i], bf, attrs[i], height, width,
                                    window=bw)
               for i in range(int(screen.shape[0]))]
        big_depth = torch.stack([o.depth for o in big])
        big_attrs = torch.stack([o.attrs for o in big])
        big_mask = torch.stack([o.mask for o in big])
        take_big = big_depth < depth
        depth = torch.minimum(depth, big_depth)
        attr = torch.where(take_big[:, None],
                           big_attrs.permute(0, 3, 1, 2), attr)
        mask = mask | big_mask

    return _shade_and_pack(attr, mask, background, shading, to_uint8,
                           channel_major_out, i420_out)


def _shade_and_pack(attr, mask, background, shading, to_uint8,
                    channel_major_out, i420_out):
    """The epilogue of :func:`render_frames_tiled`: composited attribute
    planes (B, C, H, W) + coverage (B, H, W) -> shaded frames over the
    background, quantized and laid out as asked."""
    if shading == "gouraud":
        shaded = attr[:, :3]                             # (B, 3, H, W)
    else:
        col = attr[:, :3]
        nrm = attr[:, 3:6]
        L = _unit_light(col)
        n = nrm / torch.clamp(torch.linalg.norm(nrm, dim=1, keepdim=True),
                              min=1e-12)
        diff = torch.clamp((n * L[None, :, None, None]).sum(dim=1).abs(),
                           0.0, 1.0)
        shaded = col * (0.35 + 0.65 * diff)[:, None]
    img = torch.where(mask[:, None], shaded, background.permute(2, 0, 1))
    img = torch.clamp(img, 0.0, 1.0)
    if i420_out:
        return rgb_to_i420(img)
    if to_uint8:
        img = (img * 255.0 + 0.5).to(torch.uint8)
    if channel_major_out:
        return img                                       # (B, 3, H, W)
    return img.permute(0, 2, 3, 1)                       # (B, H, W, 3)


def rgb_to_i420(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float RGB in [0,1] -> (B, H*3//2, W) uint8 planar
    I420 frames (limited-range BT.601 — the convention cv2's
    ``COLOR_YUV2BGR_I420`` inverts; round-trip max err 1 LSB).

    Layout per frame: H rows of Y, then H//4 rows packing the (H/2, W/2)
    U plane, then H//4 rows of V — the I420 buffer an MP4 encoder
    consumes, so the host does one cv2.cvtColor and no channel reorg."""
    B, _, H, W = img.shape
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) / 1.772
    cr = (r - y) / 1.402
    Y = (16.0 + 219.0 * y + 0.5).to(torch.uint8)             # (B, H, W)
    # Chroma: 2x2 mean then limited-range quantize.
    cb = cb.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    cr = cr.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    U = (128.0 + 224.0 * cb + 0.5).to(torch.uint8)           # (B, H/2, W/2)
    V = (128.0 + 224.0 * cr + 0.5).to(torch.uint8)
    return torch.cat(
        [Y, U.reshape(B, H // 4, W), V.reshape(B, H // 4, W)], dim=1)


def _tile_occupancy(tri: np.ndarray, span_x: int, span_y: int,
                    height: int, width: int) -> np.ndarray:
    """Per-tile slot counts when binning these triangles with the given
    tile spans (rest-pose estimate for chunk-budget sizing)."""
    TX = width // TR.TILE_W
    TY = height // TR.TILE_H
    count = np.zeros(TX * TY, np.int64)
    if not tri.shape[0]:
        return count
    bmin = tri.min(axis=1)
    bmax = tri.max(axis=1)
    tx0 = np.clip(np.floor(bmin[:, 0]).astype(int) // TR.TILE_W, 0, TX - 1)
    tx1 = np.clip(np.floor(bmax[:, 0]).astype(int) // TR.TILE_W, 0, TX - 1)
    ty0 = np.clip(np.floor(bmin[:, 1]).astype(int) // TR.TILE_H, 0, TY - 1)
    ty1 = np.clip(np.floor(bmax[:, 1]).astype(int) // TR.TILE_H, 0, TY - 1)
    for dy in range(span_y):
        for dx in range(span_x):
            tid = np.clip(ty0 + dy, 0, TY - 1) * TX + np.clip(tx0 + dx, 0,
                                                              TX - 1)
            ok = (ty0 + dy <= ty1) & (tx0 + dx <= tx1)
            np.add.at(count, tid[ok], 1)
    return count


def _chunk_budget(counts: np.ndarray, slack: float) -> int:
    """CSR chunk budget for rest-pose per-tile slot ``counts``: every tile
    owns >=1 chunk; slack absorbs animation deformation."""
    per_tile = np.maximum(-(-counts * slack // TR.CF_FUSED), 1)
    return int(per_tile.sum())


def _project_np(verts: np.ndarray, cam_t, height: int, width: int,
                focal: float) -> np.ndarray:
    """Host float64 projection of rest-pose vertices -> (V, 2) pixels."""
    v = np.asarray(verts, np.float64) @ _PRE_ROT.T
    v = (v + np.asarray(cam_t)) @ _FLIP_YZ.T
    z = np.maximum(-v[:, 2], 1e-6)
    xs = v[:, 0] / z * focal + width / 2.0
    ys = -v[:, 1] / z * focal + height / 2.0
    return np.stack([xs, ys], axis=1)


def plan_tiled_render(verts: np.ndarray, faces: np.ndarray, cam_t,
                      height: int = DEFAULT_SIZE, width: int = DEFAULT_SIZE,
                      focal: float = DEFAULT_FOCAL, slack: float = 1.4,
                      max_small_extent: float = 48.0,
                      ladder_bounds: Tuple[float, ...] = (96.0, 192.0,
                                                          384.0)):
    """Host-side planning for render_frames_tiled: split faces into extent
    classes from the rest pose's projected extents, size the tile spans per
    class, and bound each class's per-tile face capacity (max_chunks) and
    chunk budget from a rest-pose bin count.  ``slack`` absorbs animation
    deformation.

    Classes: extent <= max_small_extent renders in the base tiled pass;
    each ``ladder_bounds`` rung gets its own tiled pass with wider spans;
    only faces beyond the top rung fall back to the fragment-window
    path."""
    pts = _project_np(verts, cam_t, height, width, focal)
    f = np.asarray(faces)
    tri = pts[f]
    ext = (tri.max(axis=1) - tri.min(axis=1)).max(axis=1) * slack

    small_bound = min(float(max_small_extent), float(ext.max()) + 1.0)
    small = f[ext <= small_bound]
    large = f[ext > small_bound]
    span_x, span_y = TR.max_span_for(small_bound)

    occ = _tile_occupancy(tri[ext <= small_bound], span_x, span_y,
                          height, width)
    max_chunks = int(np.clip(
        np.ceil(int(occ.max()) * slack / TR.CF_FUSED), 1, 64))
    total_chunks = _chunk_budget(occ, slack)

    large_window = 256
    if large.shape[0]:
        lw = float(ext[ext > small_bound].max())
        large_window = int(min(max(np.ceil(lw / 8) * 8 + 8, 32), 512))

    # Span-ladder classes: over-span faces keep riding the tiled kernel,
    # each rung with tile spans sized for its extent bound and a CSR chunk
    # budget sized from the rung's rest-pose occupancy.
    ladder_faces, ladder_specs = [], []
    lo = small_bound
    for bound in ladder_bounds:
        if bound <= lo:
            continue
        sel_mask = (ext > lo) & (ext <= bound)
        sel = f[sel_mask]
        if sel.shape[0]:
            sx, sy = TR.max_span_for(bound)
            occ_r = _tile_occupancy(tri[sel_mask], sx, sy, height, width)
            nc = int(np.clip(
                np.ceil(int(occ_r.max()) * slack / TR.CF_FUSED), 1, 64))
            ladder_faces.append(sel.astype(np.int32))
            ladder_specs.append((sx, sy, nc, _chunk_budget(occ_r, slack)))
        lo = bound

    # Fragment-path memory plan for faces beyond the ladder.  A single
    # rasterize call materializes faces x window^2 fragments — bucket by
    # extent into pow2 windows, then split each bucket so no call exceeds
    # FRAG_BUDGET fragments per frame; calls composite by depth inside
    # render_frames_tiled.
    large_buckets, large_windows = [], []
    frag_budget = FRAG_BUDGET
    if (ext > lo).any():
        ext_l = ext[ext > small_bound]
        huge = large[ext_l > lo]
        ext_h = ext_l[ext_l > lo]
        full_win = int(max(height, width))
        for w in (512, None):
            if w is None:
                # Catch-all: faces beyond 512 px render through a
                # frame-sized window — the clamped anchor in
                # raster.rasterize covers the visible part whatever the
                # projected bbox.
                sel = huge[ext_h > lo]
                win = full_win
            else:
                if w <= lo:
                    continue
                sel = huge[(ext_h > lo) & (ext_h <= w)]
                win = int(min(w + 8, full_win))
                lo = w
            if not sel.shape[0]:
                continue
            per_call = max(1, frag_budget // (win * win))
            for s in range(0, sel.shape[0], per_call):
                large_buckets.append(sel[s:s + per_call].astype(np.int32))
                large_windows.append(win)
    return dict(small_faces=small.astype(np.int32),
                large_faces=large.astype(np.int32),
                span_x=span_x, span_y=span_y, max_chunks=max_chunks,
                total_chunks=total_chunks,
                large_window=large_window,
                large_buckets=large_buckets,
                large_windows=tuple(large_windows),
                ladder_faces=ladder_faces,
                ladder_specs=tuple(ladder_specs))


def screen_bbox(
    verts_seq: torch.Tensor,    # (F, V, 3) posed vertices
    cam_t: torch.Tensor,
    height: int = DEFAULT_SIZE,
    width: int = DEFAULT_SIZE,
    focal: float = DEFAULT_FOCAL,
) -> torch.Tensor:
    """Projected-pixel bounds [xmin, xmax, ymin, ymax] over ALL frames
    (same camera math as render_frames/_tiled).  Rasterized coverage is
    confined to the projected vertex hull, so this bounds every
    non-background pixel of every frame; the animate path uses it to copy
    only the body window to the host."""
    s = _to_screen(_to_camera(verts_seq, cam_t), height, width, focal)
    x, y = s[..., 0], s[..., 1]
    return torch.stack([x.min(), x.max(), y.min(), y.max()])


def auto_window(verts: np.ndarray, faces: np.ndarray, cam_t,
                height: int = DEFAULT_SIZE, width: int = DEFAULT_SIZE,
                focal: float = DEFAULT_FOCAL, slack: float = 1.3,
                cap: int = 256) -> int:
    """Smallest safe per-face rasterization window for a mesh + camera.

    The fragment rasterizer's pass-1 cost is faces x window^2 candidates,
    so window is its throughput knob.  Computed host-side once per avatar
    from the projected face bounding boxes of the rest pose (with slack
    for animation deformation), rounded up to a multiple of 8.
    """
    pts = _project_np(verts, cam_t, height, width, focal)
    tri = pts[np.asarray(faces)]                    # (F, 3, 2)
    ext = (tri.max(axis=1) - tri.min(axis=1)).max()
    w = int(np.ceil(ext * slack / 8.0) * 8) + 8
    return int(min(max(w, 16), cap))


class VideoWriter:
    """cv2 MP4 writer (reference VideoWriter, lib/model2video.py:132-177)."""

    def __init__(self, path: str, fps: float = 30.0,
                 size: Tuple[int, int] = (DEFAULT_SIZE, DEFAULT_SIZE)):
        import cv2
        self._cv2 = cv2
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self.writer = cv2.VideoWriter(path, fourcc, fps, size)
        self.path = path

    def write(self, frame: np.ndarray) -> None:
        """frame: (H, W, 3) RGB — float in [0,1] or uint8."""
        self.writer.write(
            np.ascontiguousarray(quantize_u8(frame)[:, :, ::-1]))  # -> BGR

    def write_i420(self, planes: np.ndarray) -> None:
        """planes: (H*3//2, W) uint8 planar I420 (rgb_to_i420 layout)."""
        self.writer.write(self._cv2.cvtColor(
            np.ascontiguousarray(planes), self._cv2.COLOR_YUV2BGR_I420))

    def close(self) -> None:
        self.writer.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def quantize_u8(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with round-half-up — the rule
    render_frames_tiled applies on the device (``*255+0.5``), so frames
    quantized on the host (fragment path, crop canvases) carry the same
    bytes as device-quantized ones.  uint8 input passes through."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
