"""Silhouette warp stage: SMPL-rendered value maps -> photo silhouette
(port of ``tpubody.image.warp``).

Capability parity with the reference Warp stage (lib/Warp.py:17-46):
  1. extract ordered boundaries of the photo mask and the SMPL value-map
     silhouette,
  2. match the boundaries (monotone DP),
  3. move every SMPL-interior pixel with mean-value coordinates w.r.t. the
     matched boundary polygon,
  4. scatter the (H, W, C) value map to the warped positions,
  5. fill holes and smooth.

Step 5 is not the reference's per-pixel python loop (8-neighbor MVC +
sklearn 1-NN fallback + box/median smoothing, lib/Warp.py:354-456): hole
filling is either a pull-push pyramid (the default) or a *fixed-point
masked diffusion*, in which every unfilled mask pixel repeatedly takes the
mean of its filled 3x3 neighbors until the mask is saturated.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.image import boundary_match, contours, morphology, mvc


def _sub(timer, name: str):
    """Substage context: times (and synchronises with the device) when a
    timer is passed, free otherwise."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


class WarpResult(NamedTuple):
    value: torch.Tensor       # (H, W, C) warped + filled value map
    warped_raw: torch.Tensor  # (H, W, C) before hole filling
    match: np.ndarray         # (m,) matched smpl-boundary indices
    rgb_bound: np.ndarray     # (m, 2)
    smpl_bound: np.ndarray    # (n, 2)


def silhouette_from_value(value: torch.Tensor) -> torch.Tensor:
    """Foreground mask of a rendered value map: background is where the
    front OR back normal channels are the all-ones clear color
    (reference lib/Warp.py:24)."""
    front_clear = (value[..., 0:3] == 1.0).all(dim=-1)
    back_clear = (value[..., 3:6] == 1.0).all(dim=-1)
    return ~(front_clear | back_clear)


def scatter_warp(value: torch.Tensor, src_pts: torch.Tensor,
                 dst_pts: torch.Tensor) -> torch.Tensor:
    """Scatter value[src] -> out[dst] with bounds clipping
    (reference warp_map, lib/Warp.py:220-248).

    src_pts/dst_pts: (n, 2) as (x, y).  Where several sources land on one
    pixel the LAST of them in ``src_pts`` order is kept, as the sequential
    scatter of ``tpubody`` on the CPU keeps it: the owner of each pixel is
    found with a maximum over source indices (an integer reduction, so the
    result does not depend on the order of the device's atomics) and the
    values are then gathered.
    """
    H, W = value.shape[:2]
    dst = torch.round(dst_pts).to(torch.int32)
    x = torch.clamp(dst[:, 0], 0, W - 1)
    y = torch.clamp(dst[:, 1], 0, H - 1)
    src = src_pts.to(torch.int64)
    lin = (y.to(torch.int64) * W + x)
    n = lin.shape[0]
    owner = torch.full((H * W,), -1, dtype=torch.int64, device=value.device)
    owner.scatter_reduce_(0, lin, torch.arange(n, device=value.device),
                          "amax", include_self=True)
    hit = owner >= 0
    win = src[owner.clamp(min=0)]                      # (H*W, 2)
    vals = value[win[:, 1], win[:, 0], :]
    return torch.where(hit[:, None], vals, torch.zeros_like(vals)
                       ).reshape(value.shape)


def _fill_holes_full(value: torch.Tensor, mask: torch.Tensor,
                     max_iters: int = 512) -> Tuple[torch.Tensor, int]:
    """fill_holes returning (img, iterations): see fill_holes.  The loop's
    exit test reads one flag from the device per iteration."""
    m = mask.to(torch.bool)
    filled = (value.abs().sum(dim=-1) > 0) & m
    img = value
    it = 0
    while it < max_iters and bool((m & ~filled).any()):
        fm = filled.to(img.dtype)
        num = morphology.box_blur(img * fm[..., None], 3)
        den = morphology.box_blur(fm, 3)
        can_fill = m & ~filled & (den > 1e-8)
        newvals = num / torch.clamp(den, min=1e-8)[..., None]
        img = torch.where(can_fill[..., None], newvals, img)
        filled = filled | can_fill
        it += 1
    return img, it


def fill_holes(value: torch.Tensor, mask: torch.Tensor,
               max_iters: int = 512) -> torch.Tensor:
    """Fixed-point diffusion fill: unfilled mask pixels take the mean of
    filled 3x3 neighbors; iterate until saturated."""
    return _fill_holes_full(value, mask, max_iters)[0]


def fill_holes_pyramid(value: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """Pull-push hole fill: O(log n) fixed passes instead of the
    diffusion fill's data-dependent loop (up to 512 sequential 3x3 passes
    over the full H x W x C block).

    Pull builds masked 2x2-mean levels; push fills each level's holes
    from the next-coarser level.  Same contract as ``fill_holes``
    (unfilled mask pixels get neighborhood-consistent values, everything
    else passes through; replaces the reference's sklearn 1-NN edge fill,
    lib/Warp.py:43-46): values differ from the diffusion fixed point but
    stay in the local value range, and the warp stage's masked box smooth
    runs after either fill.
    """
    m = mask.to(torch.bool)
    filled0 = (value.abs().sum(dim=-1) > 0) & m
    v = torch.where(filled0[..., None], value, torch.zeros_like(value))
    w = filled0.to(value.dtype)
    H, W = int(v.shape[0]), int(v.shape[1])

    levels = []
    while H > 1 or W > 1:
        levels.append((v, w))
        H2, W2 = (H + 1) // 2, (W + 1) // 2
        v = F.pad(v, (0, 0, 0, W2 * 2 - W, 0, H2 * 2 - H))
        w = F.pad(w, (0, W2 * 2 - W, 0, H2 * 2 - H))
        vs = (v * w[..., None]).reshape(H2, 2, W2, 2, -1).sum(dim=(1, 3))
        ws = w.reshape(H2, 2, W2, 2).sum(dim=(1, 3))
        v = vs / torch.clamp(ws, min=1.0)[..., None]
        w = (ws > 0).to(value.dtype)
        H, W = H2, W2

    for vf, wf in reversed(levels):
        Hf, Wf = int(vf.shape[0]), int(vf.shape[1])
        up = v.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        v = torch.where(wf[..., None] > 0, vf, up[:Hf, :Wf])

    return torch.where(filled0[..., None], value,
                       torch.where(m[..., None], v, value))


def smooth_filled(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One masked 3x3 mean pass over the filled map (reference's box
    smoothing loop, lib/Warp.py:424-445)."""
    out = morphology.masked_box_smooth(value, mask, 3)
    return torch.where(mask[..., None], out, value)


def smooth_weight_channels(value: torch.Tensor) -> torch.Tensor:
    """Median(5) + box(3) + median(3) over the 24 skinning-weight channels
    (channels 6:, reference lib/Warp.py:441-450), over all channels
    instead of 8 separate 3-channel cv2 calls."""
    w = value[..., 6:]
    w = morphology.median_blur(w, 5)
    w = morphology.box_blur(w, 3)
    w = morphology.median_blur(w, 3)
    return torch.cat([value[..., :6], w], dim=-1)


def warp_stage(
    rgb_mask: np.ndarray,
    smplh_value,
    k: int = 64,
    smooth_weights: bool = True,
    fill: str = "pyramid",
    timer=None,
    device: DeviceLike = "cuda",
) -> WarpResult:
    """Full warp stage (reference Wrap.__call__, lib/Warp.py:28-46).

    Args:
      rgb_mask: (H, W) photo silhouette (nonzero = person).
      smplh_value: (H, W, C>=6) rendered SMPL value map (front/back normals
        + skinning weights), background = 1.0 in the normal channels.  A
        tensor stays on its own device (the value block then never crosses
        the host boundary: it is ~126 MB at 1024^2 x 30); an array is put
        on ``device``.
      timer: optional StageTimer for substage attribution (each substage
        then ends in a device synchronisation; leave None in production).
    """
    with _sub(timer, "warp/to_device"):
        if isinstance(smplh_value, torch.Tensor):
            value = smplh_value.to(torch.float32)
        else:
            value = torch.as_tensor(np.asarray(smplh_value, np.float32),
                                    device=resolve(device))
        dev = value.device
    with _sub(timer, "warp/silhouette"):
        smpl_mask = silhouette_from_value(value).cpu().numpy()

    # Host: ordered boundary polygons (data-dependent lengths).
    with _sub(timer, "warp/contours"):
        rgb_contour = contours.trace_boundary(rgb_mask)
        rgb_bound = contours.simplify(rgb_contour)
        smpl_bound = contours.trace_boundary(smpl_mask)
        if rgb_bound.shape[0] < 4 or smpl_bound.shape[0] < 4:
            raise ValueError(
                "warp_stage: degenerate silhouette (photo mask "
                f"{rgb_bound.shape[0]} pts, rendered mask "
                f"{smpl_bound.shape[0]} pts): check the mask and value map")

    # Device: monotone DP match.
    with _sub(timer, "warp/match"):
        match = boundary_match.match_boundaries(smpl_bound, rgb_bound, k=k,
                                                device=dev)
        smpl_bound_matched = smpl_bound[match]

    # Device: MVC transport of all interior pixels.
    with _sub(timer, "warp/inner_points"):
        inner = contours.inner_points(smpl_mask)
    with _sub(timer, "warp/mvc"):
        inner_t = torch.as_tensor(inner, device=dev)
        warp_fn = (mvc.warp_points_chunked if inner.shape[0] > 65536
                   else mvc.warp_points)
        warped = warp_fn(
            inner_t.to(torch.float32),
            torch.as_tensor(smpl_bound_matched, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(rgb_bound, dtype=torch.float32, device=dev))

    with _sub(timer, "warp/scatter"):
        raw = scatter_warp(value, inner_t, warped)

    mask = torch.as_tensor(np.asarray(rgb_mask) != 0, device=dev)
    with _sub(timer, "warp/fill_holes"):
        if fill == "pyramid":
            filled = fill_holes_pyramid(raw, mask)
        else:
            filled, fill_iters = _fill_holes_full(raw, mask)
            if timer is not None:
                timer.records.append({"stage": "warp/fill_holes_iters",
                                      "seconds": int(fill_iters)})
    with _sub(timer, "warp/smooth"):
        filled = smooth_filled(filled, mask)
        if smooth_weights and value.shape[-1] > 6:
            filled = smooth_weight_channels(filled)
        filled = torch.where(mask[..., None], filled,
                             torch.zeros_like(filled))
    return WarpResult(
        value=filled, warped_raw=raw, match=match,
        rgb_bound=rgb_bound, smpl_bound=smpl_bound)
