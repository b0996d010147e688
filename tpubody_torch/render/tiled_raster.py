"""Tiled rasterizer: the CUDA kernels ``csrc/fused_raster.cu`` (fused
attribute interpolation) and ``csrc/zbuffer.cu`` (z-buffer only), and their
plain PyTorch versions.

Counterpart of ``tpubody/render/pallas_raster.py``: the fused half
(``_fused_rows``, ``_bin_fused``, the Pallas kernel ``_fused_kernel`` and
its launcher ``_fused_call``, ``render_attrs_tiled``) and the z-buffer
half (``bin_faces``, the Pallas kernel ``_raster_kernel`` and its launcher
``zbuffer_tiled``, ``rasterize_tiled``).

  Binning (torch ops, :func:`_bin_fused`): each face is assigned to the
    8x128-pixel tiles its bbox overlaps (stable sort by tile id), and the
    face-tile slots are cut into chunks of ``CF_FUSED`` faces: a flat CSR
    list of chunks per frame plus per-tile chunk ranges.  Edge functions,
    the quantized depth and every attribute plane are affine in pixel
    coordinates, so a face is ``3 * (5 + C)`` coefficients (a, b, c) with
    value ``(a * px + b * py) + c``; the constant terms are evaluated at
    the chunk's tile origin (global f32 pixel coordinates cancel at
    1024^2), and the kernel works in tile-local coordinates.

  Kernel (:func:`fused_raster`): a cluster of k thread blocks per (frame,
    tile) (:func:`cluster_for`) splits the tile's chunk range (block r
    walks chunks r, r + k, ...); each of a block's 8 warps owns a 32 x 4 pixel
    rectangle and evaluates only the faces that can reach it
    (:func:`warp_rejects`, a conservative corner test); per pixel the
    minimum packed key ``(depth << bits) | face`` and its owner are kept,
    the blocks combine their keys, and the owner's attribute planes are
    evaluated once at the end.  It writes ``win`` and the attribute planes
    in image layout.  :func:`fused_raster_emulated` is that algorithm in
    torch ops (the CPU tests hold it to the plain version bit for bit).

The fused table layout is the port's own: ``(B, MAXC, CF, G, 3)`` float32
with ``G = 5 + C`` groups ``[e0, e1, e2, zq, fid, attr_0 .. attr_{C-1}]``,
so a face's coefficients are contiguous.  ``fused_raster`` launches the
kernel for CUDA tensors and raises if it cannot; CPU tensors go through
:func:`fused_raster_reference`, the same arithmetic in the same order in
plain torch ops.

  Z-buffer path (:func:`bin_faces`, :func:`zbuffer`,
    :func:`rasterize_tiled`): the same face-to-tile assignment, but a
    dense table, ``max_chunks`` chunks of ``CF`` = 128 faces per tile in
    ``tpubody``'s layout ``(B, T, NC, 5 * CF, 4)``, and a kernel that keeps
    only the minimum key; pass 2 is the fragment rasterizer's exact
    barycentric shading (``raster.shade_from_zbuf``).  Same rule:
    :func:`zbuffer` launches its kernel for CUDA tensors or raises, and
    takes :func:`zbuffer_reference` for CPU tensors.  Its kernel shares the
    fused one's design (cluster split, warp rejection, bulk-copied chunks);
    :func:`zbuffer_emulated` is its algorithm in torch ops.
"""
from __future__ import annotations

import ctypes
import os
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from tpubody_torch import native
from tpubody_torch.render import raster as raster_lib

TILE_H = 8
TILE_W = 128
LP = TILE_H * TILE_W          # pixels per tile
EPS = 1e-7                    # edge-function tolerance (normalized units)
INT32_MAX = raster_lib.INT32_MAX
MAX_ATTR = 32                 # attribute channels per fused call
CF = 128                      # faces per chunk of the z-buffer kernel
# Thread blocks a tile of both kernels, a cluster that splits the tile's
# chunks (:func:`cluster_for`): up to this many tiles a launch, 2; above, 1.
# A launch of few tiles (one 1024^2 frame: 1,024, a fifth of them live)
# leaves SMs idle while its heaviest tiles walk their chunks, and splitting
# them shortens that tail; a launch of many (8 frames: 8,192) fills the card
# without it, and the second block and the combine only cost.  Measured on
# the video's base pass at 1-8 frames (chip_smoke.py phase 9, PERF.md): 2
# is faster up to 4 frames (4,096 tiles), 1 from 6 frames on.
CLUSTER_TILES = 4096
# The kernels' warp rectangles: warp w of a tile covers the pixels
# x in 32 (w % 4) .. + 31, y in 4 (w // 4) .. + 3.
WARP_W, WARP_H, N_WARPS = 32, 4, 8
# The rejection margin as a fraction of |a| X + |b| Y + |c| (csrc/
# raster_common.cuh, edge_fails, derives it).
MARGIN_SCALE = 2.0 ** -20


def _parse_cf(value: str) -> int:
    """Faces per chunk from its setting: a power of two in [8, 128]."""
    try:
        cf = int(value)
    except ValueError:
        cf = -1
    if not 8 <= cf <= 128 or cf & (cf - 1):
        raise ValueError(
            f"TPUBODY_CF_FUSED={value!r}: faces per chunk must be a power "
            f"of two between 8 and 128")
    return cf


# Faces per chunk (import-time constant: set the variable before import).
CF_FUSED = _parse_cf(os.environ.get("TPUBODY_CF_FUSED", "32"))

# Reference: chunks evaluated at once (x CF x 1024 pixels of transients).
_REF_CHUNK_BLOCK = 64
# z-buffer reference: tiles evaluated at once (x 128 x 1024 of transients).
_REF_TILE_BLOCK = 32


def _edge_coef(ax, ay, bx, by, s):
    """Coefficients (a, b, c) with e(p) = a*px + b*py + c equal to
    cross(b - a, p - a) * s at pixel p."""
    a = -(by - ay) * s
    b = (bx - ax) * s
    c = (ax * by - ay * bx) * s
    return a, b, c


def max_span_for(extent: float) -> Tuple[int, int]:
    """Tile spans (span_x, span_y) that fully cover faces up to ``extent``
    pixels of bbox width/height."""
    sx = int(np.ceil(extent / TILE_W)) + 1
    sy = int(np.ceil(extent / TILE_H)) + 1
    return sx, sy


def _face_coefs(verts: torch.Tensor, faces: torch.Tensor,
                cull_backface: bool = False,
                depth_ascending: bool = True) -> Dict:
    """Per-face edge slopes and quantized vertex depths for verts (B, V, 3)
    in screen space and faces (F, 3): what both binners start from.

    Returns p0, p1, p2 (B, F, 2); a0..b2 edge slopes and az, bz depth-plane
    slopes, z0q..z2q, inv_area, face_ok (B, F); zmin, zscale (B,); fb and
    depth_levels.  Constant terms are left to the binners, which evaluate
    them at each tile's origin."""
    F = int(faces.shape[0])
    fb = raster_lib._face_bits(F)
    depth_levels = 1 << (31 - fb)

    xy = verts[..., :2]
    z = verts[..., 2]
    if not depth_ascending:
        z = -z
    zmin, zmax = z.amin(dim=1), z.amax(dim=1)                   # (B,)
    # float(depth_levels - 1) rounds to float32 as the weak-typed Python
    # int does in tpubody; for few faces it rounds UP to 2^(31 - fb).
    zscale = (torch.full_like(zmin, float(depth_levels - 1))
              / torch.clamp(zmax - zmin, min=1e-12))

    tri = faces.to(torch.int64)
    p0, p1, p2 = xy[:, tri[:, 0]], xy[:, tri[:, 1]], xy[:, tri[:, 2]]
    z0, z1, z2 = z[:, tri[:, 0]], z[:, tri[:, 1]], z[:, tri[:, 2]]
    area = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - \
           (p2[..., 0] - p0[..., 0]) * (p1[..., 1] - p0[..., 1])
    face_ok = area > 1e-12 if cull_backface else area.abs() > 1e-12
    inv_area = torch.where(
        face_ok, 1.0 / torch.where(face_ok, area, torch.ones_like(area)),
        torch.zeros_like(area))

    a0, b0, _ = _edge_coef(p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1],
                           inv_area)
    a1, b1, _ = _edge_coef(p2[..., 0], p2[..., 1], p0[..., 0], p0[..., 1],
                           inv_area)
    a2, b2, _ = _edge_coef(p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1],
                           inv_area)
    zm, zs = zmin[:, None], zscale[:, None]
    z0q, z1q, z2q = (z0 - zm) * zs, (z1 - zm) * zs, (z2 - zm) * zs
    az = a0 * z0q + a1 * z1q + a2 * z2q
    bz = b0 * z0q + b1 * z1q + b2 * z2q
    return dict(p0=p0, p1=p1, p2=p2, a0=a0, b0=b0, a1=a1, b1=b1, a2=a2,
                b2=b2, az=az, bz=bz, z0q=z0q, z1q=z1q, z2q=z2q,
                inv_area=inv_area, face_ok=face_ok, zmin=zmin, zscale=zscale,
                fb=fb, depth_levels=depth_levels)


def _fused_rows(verts: torch.Tensor, faces: torch.Tensor,
                attrs: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Per-face coefficient rows (B, F+1, 19 + 3C) with a zero sentinel
    last row, for verts (B, V, 3), faces (F, 3), attrs (B, V, C).

    Row layout: [x0,y0,x1,y1,x2,y2, a0,b0,a1,b1,a2,b2, az,bz,
                 z0q,z1q,z2q, fid, inv_area, A0(0..C), A1(0..C), A2(0..C)].
    """
    B = int(verts.shape[0])
    F = int(faces.shape[0])
    fc = _face_coefs(verts, faces)
    fid = torch.arange(F, dtype=verts.dtype,
                       device=verts.device).expand(B, F)
    tri = faces.to(torch.int64)
    A0, A1, A2 = attrs[:, tri[:, 0]], attrs[:, tri[:, 1]], attrs[:, tri[:, 2]]
    rows = torch.cat([
        fc["p0"], fc["p1"], fc["p2"],
        torch.stack([fc[k] for k in ("a0", "b0", "a1", "b1", "a2", "b2",
                                     "az", "bz", "z0q", "z1q", "z2q")]
                    + [fid, fc["inv_area"]], dim=-1),
        A0, A1, A2,
    ], dim=-1)
    rows = torch.cat([rows, rows.new_zeros((B, 1, rows.shape[-1]))], dim=1)
    meta = {k: fc[k] for k in ("face_ok", "p0", "p1", "p2", "zmin", "zscale",
                               "fb", "depth_levels")}
    return rows, meta


def _tile_slots(p0, p1, p2, face_ok, height: int, width: int, span_x: int,
                span_y: int):
    """Assign each face to the tiles its bbox overlaps, at most
    ``span_x * span_y`` of them, and sort the face-tile slots by tile.

    Returns (fids_s (B, F * M) int64: face of each slot in tile order;
    seg (B, T + 1): slots of tile t are [seg[t], seg[t + 1]); counts
    (B, T); M)."""
    TX, TY = width // TILE_W, height // TILE_H
    T = TX * TY
    B, F = int(p0.shape[0]), int(p0.shape[1])
    dev = p0.device
    i32 = torch.int32

    bmin = torch.minimum(torch.minimum(p0, p1), p2)
    bmax = torch.maximum(torch.maximum(p0, p1), p2)
    onscreen = (face_ok & (bmax[..., 0] >= 0) & (bmin[..., 0] < width)
                & (bmax[..., 1] >= 0) & (bmin[..., 1] < height))

    def tile_of(coord, size, last):      # floor-divide: negatives floor
        t = torch.div(torch.floor(coord).to(i32), size,
                      rounding_mode="floor")
        return torch.clamp(t, 0, last)

    tx0 = tile_of(bmin[..., 0], TILE_W, TX - 1)
    tx1 = tile_of(bmax[..., 0], TILE_W, TX - 1)
    ty0 = tile_of(bmin[..., 1], TILE_H, TY - 1)
    ty1 = tile_of(bmax[..., 1], TILE_H, TY - 1)

    M = span_x * span_y
    dx = torch.arange(span_x, dtype=i32, device=dev)
    dy = torch.arange(span_y, dtype=i32, device=dev)
    txs = tx0[..., None] + dx                            # (B, F, sx)
    tys = ty0[..., None] + dy                            # (B, F, sy)
    tid = tys[..., :, None] * TX + txs[..., None, :]     # (B, F, sy, sx)
    slot_ok = (onscreen[..., None, None]
               & (tys <= ty1[..., None])[..., :, None]
               & (txs <= tx1[..., None])[..., None, :])
    keys = torch.where(slot_ok, tid, torch.full_like(tid, T)
                       ).reshape(B, F * M)
    # Stable, like lax.sort_key_val: on overflow the dropped set depends on
    # the order of equal keys.  fids = slot // M (slots are face-major).
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    fids_s = torch.div(order, M, rounding_mode="floor")  # (B, F*M) i64
    bounds = torch.arange(T + 1, dtype=i32, device=dev).expand(B, T + 1)
    seg = torch.searchsorted(keys_s, bounds.contiguous())        # (B, T+1)
    counts = seg[:, 1:] - seg[:, :-1]                    # (B, T)
    return fids_s, seg, counts, M


def _bin_fused(verts: torch.Tensor, faces: torch.Tensor,
               attrs: torch.Tensor, height: int, width: int,
               total_chunks: int, span_x: int, span_y: int):
    """CSR chunk-list binning for the fused kernel, batched over frames.

    verts (B, V, 3) screen space, faces (F, 3), attrs (B, V, C).  Builds a
    flat list of ``total_chunks`` face chunks per frame plus per-tile chunk
    ranges; the kernel streams exactly its tile's range, so chunks beyond
    the budget are dropped (and counted in ``overflow``).

    Returns (table (B, MAXC, CF, G, 3) f32, cstarts (B, T+1) i32 per-tile
    chunk offsets, nvalid (B,) i32, overflow (B,) i32, meta) with
    G = 5 + C groups ordered [e0, e1, e2, zq, fid, attr_0..attr_{C-1}] and
    (a, b, c) per group.  No host synchronisation.
    """
    TX, TY = width // TILE_W, height // TILE_H
    T = TX * TY
    B = int(verts.shape[0])
    F = int(faces.shape[0])
    C = int(attrs.shape[-1])
    CF = CF_FUSED
    MAXC = int(total_chunks)
    dev = verts.device
    i32 = torch.int32

    rows, meta = _fused_rows(verts, faces, attrs)
    p0, p1, p2 = meta["p0"], meta["p1"], meta["p2"]
    face_ok = meta["face_ok"]

    fids_s, seg, counts, M = _tile_slots(p0, p1, p2, face_ok, height, width,
                                         span_x, span_y)

    # Chunk list: tile t owns chunks [cum[t]-nch[t], cum[t]).
    nch = torch.div(counts + CF - 1, CF, rounding_mode="floor")
    cum = torch.cumsum(nch, dim=1)
    nvalid = cum[:, -1]
    starts0 = cum - nch
    kept_ch = torch.minimum(torch.clamp(MAXC - starts0, min=0), nch)
    overflow = (counts - torch.minimum(counts, kept_ch * CF)).sum(dim=1)
    cstarts = torch.clamp(
        torch.cat([cum.new_zeros((B, 1)), cum], dim=1), max=MAXC).to(i32)

    cidx = torch.arange(MAXC, dtype=cum.dtype, device=dev).expand(B, MAXC)
    ct = torch.searchsorted(cum, cidx.contiguous(), right=True)
    ct = torch.clamp(ct, max=T - 1)                      # past-end -> last
    k = cidx - torch.gather(starts0, 1, ct)              # ordinal in tile
    fcount = torch.clamp(torch.gather(counts, 1, ct) - k * CF, 0, CF)
    fcount = torch.where(cidx < nvalid[:, None], fcount,
                         torch.zeros_like(fcount))
    slot0 = torch.clamp(torch.gather(seg, 1, ct) + k * CF, 0, F * M - 1)
    j = torch.arange(CF, dtype=cum.dtype, device=dev)
    slot = torch.clamp(slot0[..., None] + j, 0, F * M - 1)   # (B, MAXC, CF)
    fidx = torch.gather(fids_s, 1, slot.reshape(B, MAXC * CF)
                        ).reshape(B, MAXC, CF)
    fidx = torch.where(j < fcount[..., None], fidx,
                       torch.full_like(fidx, F))         # sentinel row F

    L = rows.shape[-1]
    R = torch.gather(rows, 1, fidx.reshape(B, MAXC * CF, 1)
                     .expand(B, MAXC * CF, L)).reshape(B, MAXC, CF, L)
    ox = ((ct % TX) * TILE_W).to(verts.dtype)[..., None]
    oy = (torch.div(ct, TX, rounding_mode="floor") * TILE_H
          ).to(verts.dtype)[..., None]

    x0, y0 = R[..., 0], R[..., 1]
    x1, y1 = R[..., 2], R[..., 3]
    x2, y2 = R[..., 4], R[..., 5]
    a0, b0 = R[..., 6], R[..., 7]
    a1, b1 = R[..., 8], R[..., 9]
    a2, b2 = R[..., 10], R[..., 11]
    az, bz = R[..., 12], R[..., 13]
    z0q, z1q, z2q = R[..., 14], R[..., 15], R[..., 16]
    fidv = R[..., 17]
    ia = R[..., 18]

    def cross_at_origin(ax_, ay_, bx_, by_):
        return ((bx_ - ax_) * (oy - ay_) - (ox - ax_) * (by_ - ay_)) * ia

    is_sent = fidx == F
    minus1 = torch.full_like(ia, -1.0)
    c0 = torch.where(is_sent, minus1, cross_at_origin(x1, y1, x2, y2))
    c1 = torch.where(is_sent, minus1, cross_at_origin(x2, y2, x0, y0))
    c2 = torch.where(is_sent, minus1, cross_at_origin(x0, y0, x1, y1))
    cz = c0 * z0q + c1 * z1q + c2 * z2q

    A0 = R[..., 19:19 + C]
    A1 = R[..., 19 + C:19 + 2 * C]
    A2 = R[..., 19 + 2 * C:19 + 3 * C]
    aA = a0[..., None] * A0 + a1[..., None] * A1 + a2[..., None] * A2
    bA = b0[..., None] * A0 + b1[..., None] * A1 + b2[..., None] * A2
    cA = c0[..., None] * A0 + c1[..., None] * A1 + c2[..., None] * A2

    zero = torch.zeros_like(a0)

    def col(head, tail):      # 5 x (B, MAXC, CF) + (B, MAXC, CF, C)
        return torch.cat([torch.stack(head, dim=-1), tail], dim=-1)

    table = torch.stack([col([a0, a1, a2, az, zero], aA),
                         col([b0, b1, b2, bz, zero], bA),
                         col([c0, c1, c2, cz, fidv], cA)], dim=-1)
    return (table.contiguous(), cstarts, nvalid.to(i32), overflow.to(i32),
            meta)


def _pixel_coords(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-local pixel-centre coordinates (px, py), each (LP,), row-major
    over the 8x128 tile."""
    p = torch.arange(LP, dtype=torch.int32, device=device)
    px = (p % TILE_W).to(torch.float32) + 0.5
    py = torch.div(p, TILE_W, rounding_mode="floor").to(torch.float32) + 0.5
    return px, py


def _affine(coef: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """``(a * px + b * py) + c`` in exactly this order, each operation
    rounded to float32 (no fused multiply-add): the kernel's order."""
    return (coef[..., 0:1] * px + coef[..., 1:2] * py) + coef[..., 2:3]


def warp_rects(device=None) -> torch.Tensor:
    """(8, 4) float32: per warp of a tile the pixel-centre corners (xa, xb,
    ya, yb) of its 32 x 4 rectangle, tile-local."""
    w = torch.arange(N_WARPS, device=device)
    xa = (WARP_W * (w % 4)).to(torch.float32) + 0.5
    ya = (WARP_H * torch.div(w, 4, rounding_mode="floor")).to(
        torch.float32) + 0.5
    return torch.stack([xa, xa + (WARP_W - 1), ya, ya + (WARP_H - 1)], -1)


def pixel_warps(device=None) -> torch.Tensor:
    """(LP,) int64: the warp that owns each pixel of a tile (row-major)."""
    p = torch.arange(LP, device=device)
    x, y = p % TILE_W, torch.div(p, TILE_W, rounding_mode="floor")
    return torch.div(x, WARP_W, rounding_mode="floor") + 4 * torch.div(
        y, WARP_H, rounding_mode="floor")


def edge_fails(coef: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """The kernels' rejection of one edge function for warp rectangles, in
    their float32 order: coef (..., 3) = (a, b, c), rects (..., 4) as
    :func:`warp_rects`, broadcast against each other -> bool, True where no
    pixel centre of the rectangle can pass ``e >= -1e-7`` (a corner
    maximum plus a rounding margin; ``fmax`` ignores a NaN as ``fmaxf``
    does, and a NaN or infinite sum is kept)."""
    a, b, c = coef[..., 0], coef[..., 1], coef[..., 2]
    xa, xb, ya, yb = rects[..., 0], rects[..., 1], rects[..., 2], rects[..., 3]
    m = (torch.fmax(a * xa, a * xb) + torch.fmax(b * ya, b * yb)) + c
    s = (a.abs() * xb + b.abs() * yb) + c.abs()
    return (m + s * MARGIN_SCALE) < -EPS


def warp_rejects(edges: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """edges (..., 3, 3): a face's three edge functions (a, b, c); rects
    (..., 4) -> bool, True where the kernels skip the face for that warp:
    some edge fails at every pixel of the rectangle."""
    return (edge_fails(edges[..., 0, :], rects)
            | edge_fails(edges[..., 1, :], rects)
            | edge_fails(edges[..., 2, :], rects))


def cluster_for(tiles: int) -> int:
    """Blocks a tile for a launch over ``tiles`` (frames x tiles) tiles:
    2 up to :data:`CLUSTER_TILES` tiles, 1 above."""
    return 2 if tiles <= CLUSTER_TILES else 1


def _combine_ranks(best: torch.Tensor) -> torch.Tensor:
    """The kernels' cluster combine.  best (ranks, T, LP) int64: each
    block's ``key << 32 | owner`` per pixel (``INT32_MAX << 32`` where it
    covers nothing) -> (T, LP): the minimum key with its owner, taken from
    the one block that holds it (block 0 for pixels nothing covers)."""
    none = INT32_MAX << 32
    keys = best >> 32
    gmin = keys.amin(dim=0)
    covered = gmin != INT32_MAX
    rank0 = torch.zeros_like(keys, dtype=torch.bool)
    rank0[0] = True
    writer = torch.where(covered, keys == gmin, rank0)
    if not bool((writer.sum(dim=0) == 1).all()):
        raise RuntimeError("the cluster combine found no single writer")
    out = torch.where(writer, best, torch.full_like(best, none)).amin(dim=0)
    return torch.where(covered, out, torch.full_like(out, none))


def fused_raster_reference(table: torch.Tensor, cstarts: torch.Tensor,
                           height: int, width: int, fb: int,
                           depth_levels: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: the same function on the same
    table, (win (B, H, W) int32, attr (B, C, H, W) float32).

    Per frame the chunks are walked in blocks (a block's edge values are
    (chunks, CF, 1024) float32); each block folds into a per-tile running
    minimum of ``key << 32 | table position``, which carries the winner's
    owner with it, and the winners' attribute planes are gathered and
    evaluated once at the end."""
    B, MAXC, CF, G, _ = table.shape
    C = G - 5
    TX, TY = width // TILE_W, height // TILE_H
    T = TX * TY
    dev = table.device
    px, py = _pixel_coords(dev)
    zcap = float(depth_levels - 1)
    none = (INT32_MAX << 32)
    wins, attrs = [], []
    for b in range(B):
        starts = cstarts[b].to(torch.int64)
        cidx = torch.arange(MAXC, dtype=torch.int64, device=dev)
        ct = torch.searchsorted(starts[1:].contiguous(), cidx, right=True)
        live = ct < T                       # chunk inside some tile's range
        ct = torch.clamp(ct, max=T - 1)
        best = torch.full((T, LP), none, dtype=torch.int64, device=dev)
        for s in range(0, MAXC, _REF_CHUNK_BLOCK):
            tab = table[b, s:s + _REF_CHUNK_BLOCK]       # (n, CF, G, 3)
            n = tab.shape[0]
            e0 = _affine(tab[:, :, 0], px, py)           # (n, CF, LP)
            e1 = _affine(tab[:, :, 1], px, py)
            e2 = _affine(tab[:, :, 2], px, py)
            zq = _affine(tab[:, :, 3], px, py)
            fid = tab[:, :, 4, 2:3].to(torch.int32)      # (n, CF, 1)
            inside = ((e0 >= -EPS) & (e1 >= -EPS) & (e2 >= -EPS)
                      & live[s:s + n, None, None])
            dq = torch.clamp(zq, 0.0, zcap).to(torch.int32)
            key = raster_lib.shift_key(dq, fb) | fid
            pos = (torch.arange(s * CF, (s + n) * CF, dtype=torch.int64,
                                device=dev).reshape(n, CF, 1))
            cand = torch.where(inside, (key.to(torch.int64) << 32) | pos,
                               torch.full_like(pos, none))
            cmin = cand.amin(dim=1)                      # (n, LP)
            best.scatter_reduce_(0, ct[s:s + n, None].expand(n, LP), cmin,
                                 "amin", include_self=True)
        win = (best >> 32).to(torch.int32)               # (T, LP)
        hit = win != INT32_MAX
        pos = torch.where(hit, best & 0xFFFFFFFF, torch.zeros_like(best))
        coef = table[b].reshape(MAXC * CF, G, 3)[:, 5:]  # (MAXC*CF, C, 3)
        own = coef[pos.reshape(-1)].reshape(T, LP, C, 3)
        val = ((own[..., 0] * px[:, None] + own[..., 1] * py[:, None])
               + own[..., 2])                            # (T, LP, C)
        val = torch.where(hit[..., None], val, torch.zeros_like(val))
        wins.append(win.reshape(TY, TX, TILE_H, TILE_W).permute(0, 2, 1, 3)
                    .reshape(height, width))
        attrs.append(val.reshape(TY, TX, TILE_H, TILE_W, C)
                     .permute(4, 0, 2, 1, 3).reshape(C, height, width))
    return torch.stack(wins), torch.stack(attrs)


def fused_raster_emulated(table: torch.Tensor, cstarts: torch.Tensor,
                          height: int, width: int, fb: int,
                          depth_levels: int, ranks: int = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in torch ops, on the same table: ``ranks``
    blocks a tile, block r taking the tile's chunks r, r + ranks, ...; a
    face evaluated only at the warps that :func:`warp_rejects` keeps; each
    block's minimum of ``key << 32 | owner`` per pixel; the blocks combined
    by :func:`_combine_ranks`; the winner's attribute planes evaluated
    once; ``ranks`` as the kernel's launch takes it where None.  -> (win,
    attr) as :func:`fused_raster_reference`, which it equals bit for bit
    when the rejection is conservative."""
    B, MAXC, CF_, G, _ = table.shape
    C = G - 5
    TX, TY = width // TILE_W, height // TILE_H
    T = TX * TY
    ranks = ranks or cluster_for(B * T)
    dev = table.device
    px, py = _pixel_coords(dev)
    rects, pw = warp_rects(dev), pixel_warps(dev)
    zcap = float(depth_levels - 1)
    none = (INT32_MAX << 32)
    wins, attrs = [], []
    for b in range(B):
        starts = cstarts[b].to(torch.int64)
        cidx = torch.arange(MAXC, dtype=torch.int64, device=dev)
        ct = torch.searchsorted(starts[1:].contiguous(), cidx, right=True)
        live = ct < T
        ct = torch.clamp(ct, max=T - 1)
        rank = (cidx - starts[ct]) % ranks          # the block that walks it
        best = torch.full((ranks * T, LP), none, dtype=torch.int64,
                          device=dev)
        for s in range(0, MAXC, _REF_CHUNK_BLOCK):
            tab = table[b, s:s + _REF_CHUNK_BLOCK]       # (n, CF, G, 3)
            n = tab.shape[0]
            keep = ~warp_rejects(tab[:, :, None, 0:3], rects)  # (n, CF, 8)
            e0 = _affine(tab[:, :, 0], px, py)
            e1 = _affine(tab[:, :, 1], px, py)
            e2 = _affine(tab[:, :, 2], px, py)
            zq = _affine(tab[:, :, 3], px, py)
            fid = tab[:, :, 4, 2:3].to(torch.int32)
            inside = ((e0 >= -EPS) & (e1 >= -EPS) & (e2 >= -EPS)
                      & keep[:, :, pw] & live[s:s + n, None, None])
            dq = torch.clamp(zq, 0.0, zcap).to(torch.int32)
            key = raster_lib.shift_key(dq, fb) | fid
            pos = (torch.arange(s * CF_, (s + n) * CF_, dtype=torch.int64,
                                device=dev).reshape(n, CF_, 1))
            cand = torch.where(inside, (key.to(torch.int64) << 32) | pos,
                               torch.full_like(pos, none))
            row = (rank[s:s + n] * T + ct[s:s + n])[:, None].expand(n, LP)
            best.scatter_reduce_(0, row, cand.amin(dim=1), "amin",
                                 include_self=True)
        best = _combine_ranks(best.reshape(ranks, T, LP))
        win = (best >> 32).to(torch.int32)
        hit = win != INT32_MAX
        pos = torch.where(hit, best & 0xFFFFFFFF, torch.zeros_like(best))
        coef = table[b].reshape(MAXC * CF_, G, 3)[:, 5:]
        own = coef[pos.reshape(-1)].reshape(T, LP, C, 3)
        val = ((own[..., 0] * px[:, None] + own[..., 1] * py[:, None])
               + own[..., 2])
        val = torch.where(hit[..., None], val, torch.zeros_like(val))
        wins.append(win.reshape(TY, TX, TILE_H, TILE_W).permute(0, 2, 1, 3)
                    .reshape(height, width))
        attrs.append(val.reshape(TY, TX, TILE_H, TILE_W, C)
                     .permute(4, 0, 2, 1, 3).reshape(C, height, width))
    return torch.stack(wins), torch.stack(attrs)


def fused_raster(table: torch.Tensor, cstarts: torch.Tensor, height: int,
                 width: int, fb: int, depth_levels: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused rasterize + interpolate on a CSR chunk table ->
    (win (B, H, W) int32 packed keys, INT32_MAX where nothing covers the
    pixel; attr (B, C, H, W) float32, zero there).

    table (B, MAXC, CF, 5 + C, 3) float32 and cstarts (B, T + 1) int32 as
    :func:`_bin_fused` builds them, both contiguous.  CUDA tensors go
    through the kernel (or this raises); CPU tensors through
    :func:`fused_raster_reference`."""
    if height % TILE_H or width % TILE_W:
        raise ValueError("height must be a multiple of 8 and width of 128")
    if table.dim() != 5:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected "
                         f"(B, MAXC, CF, 5 + C, 3)")
    device = table.device
    B, C = table.shape[0], table.shape[3] - 5
    T = (width // TILE_W) * (height // TILE_H)
    if C < 0 or C > MAX_ATTR:
        raise ValueError(f"at most {MAX_ATTR} attribute channels per call, "
                         f"got {C}")
    if device.type == "cpu":
        return fused_raster_reference(table, cstarts, height, width, fb,
                                      depth_levels)
    if device.type != "cuda":
        raise ValueError(f"fused_raster runs on CUDA or CPU tensors, got "
                         f"{device}")
    return _fused_raster_launch(table, cstarts, height, width, fb,
                                depth_levels, cluster_for(B * T))


def _fused_raster_launch(table: torch.Tensor, cstarts: torch.Tensor,
                         height: int, width: int, fb: int, depth_levels: int,
                         cluster: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_raster`'s kernel launch on CUDA tensors, in clusters
    of ``cluster`` (1 or 2) blocks a tile."""
    device = table.device
    B, MAXC, CF, G, _ = table.shape
    C = G - 5
    T = (width // TILE_W) * (height // TILE_H)
    native.expect("table", table, (B, MAXC, CF, G, 3), torch.float32, device,
                  aligned=True)
    native.expect("cstarts", cstarts, (B, T + 1), torch.int32, device)
    win = torch.empty((B, height, width), dtype=torch.int32, device=device)
    attr = torch.empty((B, C, height, width), dtype=torch.float32,
                       device=device)
    native.launch("fused_raster", "tpubody_fused_raster", device,
                  table.data_ptr(), cstarts.data_ptr(), win.data_ptr(),
                  attr.data_ptr(), B, height, width, MAXC, CF, C, fb,
                  ctypes.c_float(float(depth_levels - 1)), cluster)
    return win, attr


def render_attrs_tiled(
    verts: torch.Tensor,       # (B, V, 3) screen space
    faces: torch.Tensor,       # (F, 3)
    attrs: torch.Tensor,       # (V, C) shared or (B, V, C) per frame
    height: int,
    width: int,
    max_chunks: int = 8,
    span_x: int = 2,
    span_y: int = 5,
    total_chunks: int = None,
    channel_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused rasterize+interpolate for batched frames (CSR chunk list).

    ``total_chunks`` is the face-chunk budget per frame (size it with
    ``plan_tiled_render``); when None it defaults to the dense equivalent
    T * (max_chunks + 1).  Returns (attr, mask (B, H, W), depth (B, H, W),
    overflow ()) with attr (B, H, W, C), or (B, C, H, W), the kernel's own
    layout, when ``channel_major``.  Depth is reconstructed from the
    quantized winner key.  ``overflow`` stays a tensor: nothing here
    synchronises with the host.
    """
    if height % TILE_H or width % TILE_W:
        raise ValueError("height must be a multiple of 8 and width of 128")
    B = int(verts.shape[0])
    C = int(attrs.shape[-1])
    if C > MAX_ATTR:
        raise ValueError(f"at most {MAX_ATTR} attribute channels per call")
    F = int(faces.shape[0])
    T = (width // TILE_W) * (height // TILE_H)
    if total_chunks is None:
        total_chunks = T * (max_chunks + 1)
    MAXC = int(total_chunks)
    if MAXC < T:
        raise ValueError(f"total_chunks={MAXC} must be >= the tile count "
                         f"{T} (every tile owns at least one chunk)")
    fb = raster_lib._face_bits(F)
    depth_levels = 1 << (31 - fb)

    if attrs.dim() == 2:
        attrs = attrs.expand((B,) + tuple(attrs.shape))
    table, cstarts, _, overflow, meta = _bin_fused(
        verts, faces, attrs, height, width, MAXC, span_x, span_y)
    win, attr = fused_raster(table, cstarts, height, width, fb,
                             depth_levels)

    hit = win != INT32_MAX
    dq = torch.where(hit, win >> fb, torch.zeros_like(win)).to(verts.dtype)
    zmin = meta["zmin"][:, None, None]
    zscale = meta["zscale"][:, None, None]
    depth = torch.where(hit, zmin + dq / zscale,
                        torch.full_like(dq, float("inf")))
    attr = torch.where(hit[:, None], attr, torch.zeros_like(attr))
    if not channel_major:
        attr = attr.permute(0, 2, 3, 1)               # (B, H, W, C)
    return attr, hit, depth, overflow.sum()


# ---------------------------------------------------------------------------
# The z-buffer path: dense per-tile tables, the zbuffer kernel, and the
# drop-in for raster.rasterize.
# ---------------------------------------------------------------------------


def bin_faces(
    verts: torch.Tensor,       # (B, V, 3) screen space x_pix, y_pix, depth
    faces: torch.Tensor,       # (F, 3)
    height: int,
    width: int,
    max_chunks: int,           # NC: per-tile face capacity = NC * 128
    span_x: int = 2,
    span_y: int = 5,
    cull_backface: bool = False,
    depth_ascending: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense per-tile coefficient table for the z-buffer kernel, batched
    over frames (``tpubody`` bins one frame and ``vmap``s).

    span_x/span_y bound how many tiles a face's bbox may overlap
    (span_x=2, span_y=5 covers faces up to ~32 px extent with 8x128 tiles);
    wider faces are only rendered in the tiles within the span.  Faces
    past a tile's capacity are dropped and counted.

    Returns (table (B, T, NC, 5 * CF, 4) f32: per chunk the groups
    [e0, e1, e2, zq, fid] of CF rows (a, b, c, 0), unused slots filled
    with a sentinel that fails the inside test; nchunks (B, T) i32;
    overflow (B,) i32).  No host synchronisation.
    """
    TX, TY = width // TILE_W, height // TILE_H
    T = TX * TY
    B = int(verts.shape[0])
    F = int(faces.shape[0])
    NC = int(max_chunks)
    cap = NC * CF
    dev = verts.device
    i32 = torch.int32

    fc = _face_coefs(verts, faces, cull_backface, depth_ascending)
    fids_s, seg, counts, M = _tile_slots(
        fc["p0"], fc["p1"], fc["p2"], fc["face_ok"], height, width, span_x,
        span_y)
    overflow = torch.clamp(counts - cap, min=0).sum(dim=1)
    counts_c = torch.clamp(counts, max=cap)
    nchunks = torch.div(counts_c + CF - 1, CF, rounding_mode="floor")

    # Dense per-tile face-index table (sentinel F for empty slots).
    j = torch.arange(cap, dtype=seg.dtype, device=dev)
    slot = torch.clamp(seg[:, :-1, None] + j, 0, F * M - 1)   # (B, T, cap)
    fidx = torch.gather(fids_s, 1, slot.reshape(B, T * cap)
                        ).reshape(B, T, cap)
    is_sent = j >= counts_c[..., None]
    fidx = torch.where(is_sent, torch.full_like(fidx, F), fidx)

    # Per-face rows with a zero sentinel row at index F, gathered per slot.
    rows = torch.cat(
        [torch.stack([fc[k] for k in ("a0", "a1", "a2", "az", "b0", "b1",
                                      "b2", "bz", "inv_area", "z0q", "z1q",
                                      "z2q")], dim=-1),
         fc["p0"], fc["p1"], fc["p2"]], dim=-1)               # (B, F, 18)
    rows = torch.cat([rows, rows.new_zeros((B, 1, rows.shape[-1]))], dim=1)
    L = rows.shape[-1]
    R = torch.gather(rows, 1, fidx.reshape(B, T * cap, 1)
                     .expand(B, T * cap, L)).reshape(B, T, cap, L)
    ia = R[..., 8]
    zq0, zq1, zq2 = R[..., 9], R[..., 10], R[..., 11]
    q0, q1, q2 = R[..., 12:14], R[..., 14:16], R[..., 16:18]

    # Constant terms at each slot's TILE ORIGIN, in the cross-product form
    # (differences stay O(tile + face); global f32 cancels at 1024^2).
    tile_ids = torch.arange(T, dtype=i32, device=dev)
    ox = ((tile_ids % TX) * TILE_W).to(verts.dtype)[:, None]      # (T, 1)
    oy = (torch.div(tile_ids, TX, rounding_mode="floor") * TILE_H
          ).to(verts.dtype)[:, None]

    def edge_at_origin(a, b):
        return ((b[..., 0] - a[..., 0]) * (oy - a[..., 1])
                - (ox - a[..., 0]) * (b[..., 1] - a[..., 1])) * ia

    c0 = edge_at_origin(q1, q2)                           # (B, T, cap)
    c1 = edge_at_origin(q2, q0)
    c2 = edge_at_origin(q0, q1)
    cz = c0 * zq0 + c1 * zq1 + c2 * zq2
    minus1 = torch.full_like(ia, -1.0)
    zero = torch.zeros_like(ia)
    c0 = torch.where(is_sent, minus1, c0)                 # sentinel: fail
    c1 = torch.where(is_sent, minus1, c1)
    c2 = torch.where(is_sent, minus1, c2)
    cz = torch.where(is_sent, zero, cz)
    fid_v = torch.where(is_sent, zero, fidx.to(verts.dtype))

    A = torch.cat([R[..., 0:4], zero[..., None]], dim=-1)         # (.., 5)
    Bc = torch.cat([R[..., 4:8], zero[..., None]], dim=-1)
    Cc = torch.stack([c0, c1, c2, cz, fid_v], dim=-1)
    # -> (B, T, NC, 5, CF, 4): chunk, group, face lane, column.
    tab = torch.stack([A, Bc, Cc, torch.zeros_like(A)], dim=-1)
    tab = tab.reshape(B, T, NC, CF, 5, 4).permute(0, 1, 2, 4, 3, 5)
    tab = tab.reshape(B, T, NC, 5 * CF, 4).contiguous()
    return tab, nchunks.to(i32), overflow.to(i32)


def zbuffer_reference(table: torch.Tensor, nchunks: torch.Tensor,
                      height: int, width: int, fb: int,
                      depth_levels: int) -> torch.Tensor:
    """Plain torch version of the z-buffer kernel: the same function on the
    same table -> (B, H, W) int32.

    Chunk by chunk: the tiles that still have a chunk ``ci`` are evaluated
    in blocks (a block's edge values are (tiles, CF, 1024) float32) and
    folded into the per-tile running minimum."""
    B, T, NC = table.shape[:3]
    TX, TY = width // TILE_W, height // TILE_H
    dev = table.device
    px, py = _pixel_coords(dev)
    zcap = float(depth_levels - 1)
    tab = table.reshape(B * T, NC, 5, CF, 4)
    n = torch.clamp(nchunks.reshape(B * T), 0, NC)
    best = torch.full((B * T, LP), INT32_MAX, dtype=torch.int32, device=dev)
    for ci in range(int(n.max()) if n.numel() else 0):
        live = torch.nonzero(n > ci)[:, 0]
        for s in range(0, live.numel(), _REF_TILE_BLOCK):
            idx = live[s:s + _REF_TILE_BLOCK]
            coef = tab[idx, ci]                           # (n, 5, CF, 4)
            e0 = _affine(coef[:, 0], px, py)              # (n, CF, LP)
            e1 = _affine(coef[:, 1], px, py)
            e2 = _affine(coef[:, 2], px, py)
            zq = _affine(coef[:, 3], px, py)
            fid = coef[:, 4, :, 2:3].to(torch.int32)      # (n, CF, 1)
            inside = (e0 >= -EPS) & (e1 >= -EPS) & (e2 >= -EPS)
            dq = torch.clamp(zq, 0.0, zcap).to(torch.int32)
            key = raster_lib.shift_key(dq, fb) | fid
            cand = torch.where(inside, key,
                               torch.full_like(key, INT32_MAX))
            best[idx] = torch.minimum(best[idx], cand.amin(dim=1))
    return (best.reshape(B, TY, TX, TILE_H, TILE_W).permute(0, 1, 3, 2, 4)
            .reshape(B, height, width))


def zbuffer_emulated(table: torch.Tensor, nchunks: torch.Tensor,
                     height: int, width: int, fb: int, depth_levels: int,
                     ranks: int = None) -> torch.Tensor:
    """The z-buffer kernel's algorithm in torch ops, on the same table:
    ``ranks`` blocks a tile, block r taking chunks r, r + ranks, ...; a face
    evaluated only at the warps that :func:`warp_rejects` keeps; the
    blocks' minima combined per pixel.  -> (B, H, W) int32, equal to
    :func:`zbuffer_reference` bit for bit when the rejection is
    conservative; ``ranks`` as the kernel's launch takes it where None."""
    B, T, NC = table.shape[:3]
    TX, TY = width // TILE_W, height // TILE_H
    ranks = ranks or cluster_for(B * T)
    dev = table.device
    px, py = _pixel_coords(dev)
    rects, pw = warp_rects(dev), pixel_warps(dev)
    zcap = float(depth_levels - 1)
    tab = table.reshape(B * T, NC, 5, CF, 4)
    n = torch.clamp(nchunks.reshape(B * T), 0, NC)
    best = torch.full((ranks, B * T, LP), INT32_MAX, dtype=torch.int64,
                      device=dev)
    for ci in range(int(n.max()) if n.numel() else 0):
        live = torch.nonzero(n > ci)[:, 0]
        for s in range(0, live.numel(), _REF_TILE_BLOCK):
            idx = live[s:s + _REF_TILE_BLOCK]
            coef = tab[idx, ci]                           # (n, 5, CF, 4)
            edges = coef[:, 0:3, :, 0:3].permute(0, 2, 1, 3)  # (n, CF, 3, 3)
            keep = ~warp_rejects(edges[:, :, None], rects)    # (n, CF, 8)
            e0 = _affine(coef[:, 0], px, py)
            e1 = _affine(coef[:, 1], px, py)
            e2 = _affine(coef[:, 2], px, py)
            zq = _affine(coef[:, 3], px, py)
            fid = coef[:, 4, :, 2:3].to(torch.int32)
            inside = ((e0 >= -EPS) & (e1 >= -EPS) & (e2 >= -EPS)
                      & keep[:, :, pw])
            dq = torch.clamp(zq, 0.0, zcap).to(torch.int32)
            key = raster_lib.shift_key(dq, fb) | fid
            cand = torch.where(inside, key, torch.full_like(key, INT32_MAX))
            r = ci % ranks
            best[r, idx] = torch.minimum(best[r, idx],
                                         cand.amin(dim=1).to(torch.int64))
    out = (_combine_ranks(best << 32) >> 32).to(torch.int32)
    return (out.reshape(B, TY, TX, TILE_H, TILE_W).permute(0, 1, 3, 2, 4)
            .reshape(B, height, width))


def zbuffer(table: torch.Tensor, nchunks: torch.Tensor, height: int,
            width: int, fb: int, depth_levels: int) -> torch.Tensor:
    """Packed z-buffer (B, H, W) int32 from a dense tile table: per pixel
    the minimum ``(depth << fb) | face`` over the covering faces, INT32_MAX
    where nothing covers.

    table (B, T, NC, 5 * CF, 4) float32 and nchunks (B, T) int32 as
    :func:`bin_faces` builds them, both contiguous.  CUDA tensors go
    through the kernel (or this raises); CPU tensors through
    :func:`zbuffer_reference`."""
    if height % TILE_H or width % TILE_W:
        raise ValueError("height must be a multiple of 8 and width of 128")
    T = (width // TILE_W) * (height // TILE_H)
    if table.dim() != 5 or tuple(table.shape[3:]) != (5 * CF, 4) \
            or table.shape[1] != T:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected "
                         f"(B, {T}, NC, {5 * CF}, 4)")
    device = table.device
    B, _, NC = table.shape[:3]
    if device.type == "cpu":
        return zbuffer_reference(table, nchunks, height, width, fb,
                                 depth_levels)
    if device.type != "cuda":
        raise ValueError(f"zbuffer runs on CUDA or CPU tensors, got {device}")
    return _zbuffer_launch(table, nchunks, height, width, fb, depth_levels,
                           cluster_for(B * T))


def _zbuffer_launch(table: torch.Tensor, nchunks: torch.Tensor, height: int,
                    width: int, fb: int, depth_levels: int,
                    cluster: int) -> torch.Tensor:
    """:func:`zbuffer`'s kernel launch on CUDA tensors, in clusters of
    ``cluster`` (1 or 2) blocks a tile."""
    device = table.device
    B, T, NC = table.shape[:3]
    native.expect("table", table, (B, T, NC, 5 * CF, 4), torch.float32,
                  device, aligned=True)
    native.expect("nchunks", nchunks, (B, T), torch.int32, device)
    zbuf = torch.empty((B, height, width), dtype=torch.int32, device=device)
    native.launch("zbuffer", "tpubody_zbuffer", device,
                  table.data_ptr(), nchunks.data_ptr(), zbuf.data_ptr(), B,
                  height, width, NC, fb,
                  ctypes.c_float(float(depth_levels - 1)), cluster)
    return zbuf


def zbuffer_tiled(
    verts: torch.Tensor,       # (B, V, 3) screen space
    faces: torch.Tensor,       # (F, 3)
    height: int,
    width: int,
    max_chunks: int = 4,
    span_x: int = 2,
    span_y: int = 5,
    cull_backface: bool = False,
    depth_ascending: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed z-buffer (B, H, W) int32 for batched frames + overflow count
    (a tensor: nothing here synchronises with the host).

    Requires height % 8 == 0, width % 128 == 0.
    """
    if height % TILE_H or width % TILE_W:
        raise ValueError("height must be a multiple of 8 and width of 128")
    fb = raster_lib._face_bits(int(faces.shape[0]))
    tab, nchunks, overflow = bin_faces(
        verts, faces, height, width, max_chunks, span_x, span_y,
        cull_backface, depth_ascending)
    zbuf = zbuffer(tab, nchunks, height, width, fb, 1 << (31 - fb))
    return zbuf, overflow.sum()


def rasterize_tiled(
    verts: torch.Tensor,       # (V, 3) or (B, V, 3) screen space
    faces: torch.Tensor,       # (F, 3)
    attrs: torch.Tensor,       # (V, C)
    height: int,
    width: int,
    max_chunks: int = 4,
    span_x: int = 2,
    span_y: int = 5,
    cull_backface: bool = False,
    depth_ascending: bool = True,
    return_overflow: bool = False,
):
    """Drop-in tiled replacement for raster.rasterize (single frame or a
    batched leading axis; the fields of the RasterOutput then carry it).
    Faces wider than the span budget should be routed through
    raster.rasterize + merge_rasters by the caller.

    Per-tile face capacity is ``max_chunks * 128``; bins past that are
    DROPPED (missing geometry).  With ``return_overflow`` the dropped
    face-tile count is returned as ``(out, overflow)`` and stays a tensor;
    otherwise the count is read (one host synchronisation) and an overflow
    triggers a RuntimeWarning: no silent caps."""
    squeeze = verts.dim() == 2
    v = verts[None] if squeeze else verts
    zbuf, overflow = zbuffer_tiled(
        v, faces, height, width, max_chunks, span_x, span_y, cull_backface,
        depth_ascending)
    frames = [raster_lib.shade_from_zbuf(
        zz, vv, faces, attrs, height, width, depth_ascending=depth_ascending)
        for vv, zz in zip(v, zbuf)]
    out = frames[0] if squeeze else raster_lib.RasterOutput(
        *(torch.stack(field) for field in zip(*frames)))
    if return_overflow:
        return out, overflow
    n = int(overflow)
    if n:
        warnings.warn(
            f"rasterize_tiled: {n} face-tile bins overflowed the "
            f"max_chunks={max_chunks} capacity and were dropped; raise "
            f"max_chunks or rasterize oversized faces via raster.rasterize "
            f"+ merge_rasters.", RuntimeWarning, stacklevel=2)
    return out
