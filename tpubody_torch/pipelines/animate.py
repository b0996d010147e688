"""Animation pipeline: rigged avatar + motion clip -> rendered MP4.

Port of ``tpubody.pipelines.animate`` (capability parity with the
reference's video scripts, lib/model2video.py:476-604 and
lib/model2video_miaxmo.py:485-599):

  * skinning for ALL frames runs as one batched pass
    (core.lbs.skin_batch),
  * frames render in fixed-size blocks through the tiled renderer
    (render.video.render_frames_tiled; the fragment renderer for frame
    sizes that do not tile),
  * the block loop is pipelined: block k+1 is enqueued on the device
    before block k is copied, on a side stream, into pinned host memory;
    the mux (cv2) runs on its own thread and waits on the copy's event.

  * ``mesh=`` (``dist.mesh``) shards the skinned frames over the mesh's
    devices; each shard's blocks render on its device, in frame order,
  * ``multihost=True`` in a ``torch.distributed`` run
    (``dist.multihost.initialize``): each process skins and renders its
    ``process_frame_slice`` of the clip, the rendered frames gather to
    every process in process order, and process 0 muxes the MP4.
"""
from __future__ import annotations

import os
import queue as queue_lib
import threading
from typing import Optional

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.dist import mesh as mesh_lib
from tpubody_torch.io import motion as motion_lib
from tpubody_torch.mesh import rigging
from tpubody_torch.render import raster as raster_lib
from tpubody_torch.render import tiled_raster as TR
from tpubody_torch.render import video as video_lib


def animate_video(
    avatar: rigging.RiggedAvatar,
    clip: motion_lib.MotionClip,
    out_path: str,
    background: Optional[np.ndarray] = None,
    cam_t: np.ndarray = (0.0, 0.0, 2.5),
    size: int = video_lib.DEFAULT_SIZE,
    focal: float = video_lib.DEFAULT_FOCAL,
    fps: Optional[float] = None,
    stride: int = 1,
    chunk: int = 8,
    mesh=None,
    window: Optional[int] = None,
    multihost: bool = False,
    lod: Optional[int] = None,
    crop_transfer: bool = True,
    i420_transfer: Optional[bool] = None,
    shading: str = "gouraud",
    device: DeviceLike = "cuda",
) -> str:
    """Render the avatar driven by the clip into an MP4 at ``out_path``.

    ``mesh``: shard the frames over its devices (module docstring).
    ``multihost=True`` at a world size above 1: each process renders its
    frame slice on ``device`` and process 0 writes the MP4; every process
    returns ``out_path``.  At world size 1 it is the ordinary path."""
    dev = resolve(device)
    if lod:
        # Rendering LOD: vertex-cluster decimation trades triangle
        # oversampling for raster throughput.
        from tpubody_torch.mesh import decimate as decimate_lib

        avatar = decimate_lib.decimate_avatar(avatar, target_verts=lod)
    poses = clip.poses[::stride]
    trans = clip.trans[::stride]
    F = poses.shape[0]
    if multihost:
        from tpubody_torch.dist import multihost as mh

        if mh.process_count() > 1:
            return _animate_video_multihost(
                avatar, poses, trans, out_path, background, cam_t, size,
                focal, fps or (clip.fps / stride), chunk, window, shading,
                dev)
    # All-frame skinning in one pass.
    verts_all = rigging.animate(avatar, poses, trans, device=dev)

    # Crop-transfer: every body pixel of every frame lies inside the
    # clip's projected vertex bbox (render/video.py::screen_bbox); copying
    # only that window to the host cuts the device->host bytes by the
    # frame coverage ratio.  The host pastes the window onto the
    # background canvas.  (This is the one host synchronisation before the
    # block loop.)
    crop = None
    if crop_transfer:
        bb = video_lib.screen_bbox(
            verts_all, torch.as_tensor(np.asarray(cam_t, np.float32),
                                       device=dev),
            size, size, focal).cpu().numpy()
        x0 = max(int(np.floor(bb[0])) - 4, 0)
        x1 = min(int(np.ceil(bb[1])) + 5, size)
        y0 = max(int(np.floor(bb[2])) - 4, 0)
        y1 = min(int(np.ceil(bb[3])) + 5, size)
        if x1 > x0 and y1 > y0 and (x1 - x0) * (y1 - y0) < 0.7 * size * size:
            crop = (x0, x1, y0, y1)

    # When the body covers most of the frame the crop can't shrink the
    # copy — switch the device output to planar I420 instead: half the
    # bytes per frame and no host-side channel reorg.  Chroma is
    # 4:2:0-subsampled, which the MP4 codec does anyway.
    # i420_transfer: None = auto (on whenever no crop window is active);
    # False forces the uint8-RGB copy (bit-exact vs the crop path).
    # An active crop window always wins (even over i420_transfer=True).
    if i420_transfer is None:
        i420_transfer = crop is None
    renderers = {}
    for d in [dev] if mesh is None else mesh.distinct():
        renderers[d], block_len, i420 = _block_renderer(
            avatar, background, cam_t, size, focal, window, chunk,
            i420=(crop is None and i420_transfer), shading=shading,
            device=d)
    chunk = block_len

    def blocks():
        """(device, frames) of each block, in frame order: on ``dev``, or
        each shard's on its device (the padding shards cut off)."""
        if mesh is None:
            for s in range(0, F, chunk):
                yield dev, verts_all[s:s + chunk]
            return
        sharded = mesh_lib.shard_frames(
            mesh_lib.pad_frames(verts_all, mesh.size), mesh)
        per = sharded.shards[0].shape[0]
        for i, (d, shard) in enumerate(zip(mesh.devices, sharded.shards)):
            n_real = min(per, F - i * per)
            for s in range(0, n_real, chunk):
                yield d, shard[s:min(s + chunk, n_real)]

    canvas = None
    if crop is not None:
        bg = background if background is not None \
            else np.ones((size, size, 3), np.float32)
        canvas = video_lib.quantize_u8(np.asarray(bg, np.float32))

    copy_streams = {}

    def pull(frames):
        """Slice the body window on the device (when cropping) and start
        the copy to the host -> (host tensor, event or None).  On a GPU
        the copy runs on a side stream into pinned memory, behind the
        render that produced ``frames`` and beside the next block's."""
        if crop is not None:
            x0, x1, y0, y1 = crop
            if frames.dim() == 4 and frames.shape[1] == 3 \
                    and frames.shape[-1] != 3:
                frames = frames[:, :, y0:y1, x0:x1]
            else:
                frames = frames[:, y0:y1, x0:x1, :]
        fdev = frames.device
        if fdev.type != "cuda":
            return frames, None
        frames = frames.contiguous()
        if fdev not in copy_streams:
            copy_streams[fdev] = torch.cuda.Stream(fdev)
        copy_stream = copy_streams[fdev]
        rendered = torch.cuda.Event()
        rendered.record(torch.cuda.current_stream(fdev))
        host = torch.empty(frames.shape, dtype=frames.dtype,
                           pin_memory=True)
        copied = torch.cuda.Event()
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(rendered)
            host.copy_(frames, non_blocking=True)
            copied.record(copy_stream)
        frames.record_stream(copy_stream)
        return host, copied

    def emit(host, copied, n):
        if copied is not None:
            copied.synchronize()
        frames_np = host.numpy()
        if not i420:
            frames_np = _to_hwc(frames_np)
        for i in range(n):
            f = frames_np[i]
            if crop is not None:
                f = video_lib.quantize_u8(f)
                x0, x1, y0, y1 = crop
                img = canvas.copy()
                img[y0:y1, x0:x1] = f
                writer.write(img)
            elif i420:
                writer.write_i420(f)
            else:
                writer.write(f)

    writer = video_lib.VideoWriter(
        out_path, fps=fps or (clip.fps / stride), size=(size, size))
    with writer:
        q: "queue_lib.Queue" = queue_lib.Queue(maxsize=2)
        mux_err = []

        def mux_worker():
            # Keeps draining after a failure so the producer's q.put can
            # never block on a dead consumer; the error surfaces at join.
            while True:
                item = q.get()
                if item is None:
                    return
                if mux_err:
                    continue
                try:
                    emit(*item)
                except BaseException as e:
                    mux_err.append(e)

        th = threading.Thread(target=mux_worker, daemon=True)
        th.start()
        try:
            pending = None                    # (device frames, n)
            for d, block in blocks():
                n = block.shape[0]
                if n < chunk:  # pad to the block shape
                    block = torch.cat(
                        [block, block[-1:].expand(chunk - n, -1, -1)], dim=0)
                with mesh_lib.on_device(d):
                    frames = renderers[d](block)
                if pending is not None:
                    q.put((*pull(pending[0]), pending[1]))
                    if mux_err:
                        break
                pending = (frames, n)
            if pending is not None and not mux_err:
                q.put((*pull(pending[0]), pending[1]))
        finally:
            q.put(None)
            th.join()
        if mux_err:
            raise mux_err[0]
    return out_path


def _animate_video_multihost(avatar, poses, trans, out_path, background,
                             cam_t, size, focal, fps, chunk, window, shading,
                             dev) -> str:
    """Process-parallel animation: each process renders its frame slice
    on ``dev``; the rendered frames gather to every process (through the
    host) and process 0 muxes the MP4; a barrier closes it."""
    from tpubody_torch.dist import multihost as mh

    render_block, chunk, _ = _block_renderer(
        avatar, background, cam_t, size, focal, window, chunk,
        shading=shading, device=dev)
    F = poses.shape[0]
    per = -(-F // mh.process_count())          # lockstep per-process length
    start, stop = mh.process_frame_slice(F)
    local_poses = np.asarray(poses[start:stop])
    local_trans = np.asarray(trans[start:stop])
    n_local = local_poses.shape[0]
    if n_local < per:                          # the tail process pads; the
        reps = per - n_local                   # gather trims it
        src_p = local_poses[-1:] if n_local else np.zeros_like(poses[:1])
        src_t = local_trans[-1:] if n_local else np.zeros_like(trans[:1])
        local_poses = np.concatenate(
            [local_poses, np.repeat(src_p, reps, axis=0)], axis=0)
        local_trans = np.concatenate(
            [local_trans, np.repeat(src_t, reps, axis=0)], axis=0)

    verts_local = rigging.animate(avatar, local_poses, local_trans,
                                  device=dev)
    blocks = []
    for s in range(0, per, chunk):
        block = verts_local[s:s + chunk]
        n = block.shape[0]
        if n < chunk:
            block = torch.cat(
                [block, block[-1:].expand(chunk - n, -1, -1)], dim=0)
        blocks.append(_to_hwc(render_block(block).cpu().numpy())[:n])
    # (processes * per, H, W, 3) in process order; only the last process's
    # slice is padded, so [:F] is the clip in order.
    gathered = mh.gather_frames_to_host(np.concatenate(blocks, axis=0))
    if mh.process_index() == 0:
        with video_lib.VideoWriter(out_path, fps=fps,
                                   size=(size, size)) as writer:
            for i in range(F):
                writer.write(gathered[i])
    torch.distributed.barrier()
    return out_path


def _to_hwc(frames: np.ndarray) -> np.ndarray:
    """(B, 3, H, W) frames -> (B, H, W, 3) for the muxer (a view; the
    writer makes each frame contiguous)."""
    if frames.ndim == 4 and frames.shape[1] == 3 and frames.shape[-1] != 3:
        return np.moveaxis(frames, 1, -1)
    return frames


def _avatar_colors(avatar) -> np.ndarray:
    colors = np.asarray(avatar.color, np.float64)
    if colors.max() > 1.0 + 1e-6:
        colors = colors / 255.0
    return colors


def _tiled_plan(verts, faces, cam_t, size, focal, chunk, dev):
    """plan_tiled_render + its face tensors on ``dev`` + the block size
    bounded so that the transient coefficient tables of one block stay
    under ~1.5 GB (frames x the chunk budget summed over the passes)."""
    plan = video_lib.plan_tiled_render(verts, faces, np.asarray(cam_t),
                                       size, size, focal)

    def faces_on(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    tensors = dict(
        small_faces=faces_on(plan["small_faces"]),
        large_buckets=tuple(faces_on(b)
                            for b in plan["large_buckets"]) or None,
        ladder_faces=tuple(faces_on(b) for b in plan["ladder_faces"]))
    chunk_bytes = 3 * (5 + 6) * TR.CF_FUSED * 4      # (CF, G, 3) f32
    total_tc = plan["total_chunks"] + sum(
        spec[3] for spec in plan["ladder_specs"])
    chunk = max(1, min(chunk, int(1.5e9 // max(total_tc * chunk_bytes, 1))))
    return plan, tensors, chunk


def _block_renderer(avatar, background, cam_t, size, focal, window, chunk,
                    i420: bool = False, shading: str = "gouraud",
                    device: DeviceLike = "cuda"):
    """Shared per-block frame renderer: returns (render_block, chunk,
    i420_active).

    Host-side render plan: tile spans + chunk budgets for the fused tiled
    rasterizer, and the few oversized faces routed to the fragment path
    (render/video.py::plan_tiled_render).  Frame sizes that don't tile
    into 8x128 blocks fall back to the fragment renderer (which also
    disables the I420 transfer — it only exists on the tiled path).
    """
    dev = resolve(device)
    if background is None:
        background = np.ones((size, size, 3), np.float32)
    bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
    if tuple(bg.shape[:2]) != (size, size):
        raise ValueError("background must match the frame size")

    colors_t = torch.as_tensor(_avatar_colors(avatar).astype(np.float32),
                               device=dev)
    faces_t = torch.as_tensor(np.asarray(avatar.faces, np.int32), device=dev)
    cam = torch.as_tensor(np.asarray(cam_t, np.float32), device=dev)

    if size % 128 == 0:
        plan, pt, chunk = _tiled_plan(avatar.v_template, avatar.faces, cam_t,
                                      size, focal, chunk, dev)
        incidence = raster_lib.incidence_table(faces_t,
                                               len(avatar.v_template))

        def render_block(block):
            return video_lib.render_frames_tiled(
                block, pt["small_faces"], pt["large_buckets"], faces_t,
                colors_t, cam, bg, height=size, width=size, focal=focal,
                max_chunks=plan["max_chunks"], span_x=plan["span_x"],
                span_y=plan["span_y"], total_chunks=plan["total_chunks"],
                large_windows=plan["large_windows"],
                ladder_faces=pt["ladder_faces"],
                ladder_specs=plan["ladder_specs"],
                channel_major_out=True, i420_out=i420, shading=shading,
                incidence=incidence)

        return render_block, chunk, i420

    if window is None:
        window = video_lib.auto_window(
            avatar.v_template, avatar.faces, np.asarray(cam_t),
            size, size, focal)

    def render_block(block):
        return video_lib.render_frames(
            block, faces_t, colors_t, cam, bg,
            height=size, width=size, focal=focal, window=window)

    return render_block, chunk, False


def orbit_video(
    avatar: rigging.RiggedAvatar,
    out_path: str,
    pose: Optional[np.ndarray] = None,
    n_frames: int = 120,
    cam_t: np.ndarray = (0.0, 0.0, 2.5),
    device: DeviceLike = "cuda",
    **kw,
) -> str:
    """Turntable render: the camera orbits a single posed avatar
    (reference open3d_camera_render, lib/model2video.py:348-474 —
    implemented as an equivalent per-frame y-rotation of the mesh, which
    keeps the batched renderer's fixed camera)."""
    dev = resolve(device)
    p = np.zeros((1, 24, 3)) if pose is None else np.asarray(pose)[None]
    verts = rigging.animate(avatar, p, device=dev)[0].cpu().numpy()
    center = verts.mean(axis=0)
    angles = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    frames = []
    for a in angles:
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        frames.append((verts - center) @ R.T + center)
    size = kw.get("size", video_lib.DEFAULT_SIZE)
    focal = kw.get("focal", video_lib.DEFAULT_FOCAL)
    chunk = kw.get("chunk", 8)
    bg = torch.ones((size, size, 3), dtype=torch.float32, device=dev)
    varr = torch.as_tensor(np.stack(frames).astype(np.float32), device=dev)
    faces_t = torch.as_tensor(np.asarray(avatar.faces, np.int32), device=dev)
    colors_t = torch.as_tensor(_avatar_colors(avatar).astype(np.float32),
                               device=dev)
    cam = torch.as_tensor(np.asarray(cam_t, np.float32), device=dev)
    tiled = size % 128 == 0
    if tiled:
        # Plan from the orbit's first frame (extents are rotation-stable
        # up to the slack factor).
        plan, pt, chunk = _tiled_plan(frames[0], avatar.faces, cam_t, size,
                                      focal, chunk, dev)
        incidence = raster_lib.incidence_table(faces_t,
                                               len(avatar.v_template))
    with video_lib.VideoWriter(out_path, fps=30.0,
                               size=(size, size)) as writer:
        for s0 in range(0, n_frames, chunk):
            block = varr[s0:s0 + chunk]
            n = block.shape[0]
            if n < chunk:
                block = torch.cat(
                    [block, block[-1:].expand(chunk - n, -1, -1)], dim=0)
            if tiled:
                imgs = video_lib.render_frames_tiled(
                    block, pt["small_faces"], pt["large_buckets"], faces_t,
                    colors_t, cam, bg, height=size, width=size, focal=focal,
                    max_chunks=plan["max_chunks"], span_x=plan["span_x"],
                    span_y=plan["span_y"],
                    total_chunks=plan["total_chunks"],
                    large_windows=plan["large_windows"],
                    ladder_faces=pt["ladder_faces"],
                    ladder_specs=plan["ladder_specs"], incidence=incidence)
            else:
                imgs = video_lib.render_frames(
                    block, faces_t, colors_t, cam, bg,
                    height=size, width=size, focal=focal)
            arr = imgs.cpu().numpy()
            for i in range(n):
                writer.write(arr[i])
    return out_path


def animate_from_amass(avatar_path: str, amass_path: str, out_path: str,
                       stride: int = 2, **kw) -> str:
    """Reference main_or parity (lib/model2video.py:533-553; frame stride 2
    :514-522)."""
    avatar = rigging.load_avatar(avatar_path)
    clip = motion_lib.read_amass(amass_path)
    return animate_video(avatar, clip, out_path, stride=stride, **kw)


def animate_from_mixamo(avatar_path: str, mixamo_path: str, out_path: str,
                        **kw) -> str:
    """Reference model2video_miaxmo main_or parity (stride 1, :524-533)."""
    avatar = rigging.load_avatar(avatar_path)
    clip = motion_lib.read_mixamo(mixamo_path)
    return animate_video(avatar, clip, out_path, stride=1, **kw)


def animate_mixamo_batch(avatar_path: str, mixamo_root: str, out_dir: str,
                         prefix: str = "or_", **kw) -> list:
    """Render every Mixamo clip under ``mixamo_root`` (one subdirectory per
    clip holding ``result.pkl``, like data/mixamo/0007..0145) to
    ``<out_dir>/<prefix><clip>.mp4`` — the reference's batch __main__ loop
    (lib/model2video_miaxmo.py:553-576, 601-611).  The avatar loads once."""
    avatar = rigging.load_avatar(avatar_path)
    outs = []
    for name in sorted(os.listdir(mixamo_root)):
        pkl = os.path.join(mixamo_root, name, "result.pkl")
        if not os.path.isfile(pkl):
            continue
        clip = motion_lib.read_mixamo(pkl)
        out_path = os.path.join(out_dir, f"{prefix}{name}.mp4")
        outs.append(animate_video(avatar, clip, out_path, stride=1, **kw))
    return outs
