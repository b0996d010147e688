"""One process of the two-process run of tests/test_torch_multihost.py
(``tpubody_torch.dist.multihost`` on ``torch.distributed`` with gloo).

    python tests/torch_multihost_worker.py <rank> <world> <port> <outdir>

Joins the group at tcp://localhost:<port>, then writes into <outdir>:
``slice_<rank>.npy`` (its process_frame_slice of 24 frames),
``out_<rank>.npy`` (every process's frames * 2 + 1, gathered),
``mean_<rank>.npy`` (the mean of all frames by ``all_reduce``), and, from
``animate_video(multihost=True)`` on the sphere avatar at 64^2 with 8
frames, rank 0's ``clip.mp4`` and ``frames_0.npy`` (the frames handed to
its MP4 writer).  Imports no JAX: the parent compares.
"""
import os
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 24
CLIP_FRAMES = 8
SIZE = 64


def sphere_avatar(seed=2, n_lat=8, n_lon=8, radius=0.5):
    """A UV sphere rigged to a seeded 24-joint tree."""
    from tpubody_torch.mesh import rigging
    from tpubody_torch.models import params

    verts, faces = [], []
    for i in range(n_lat):
        th = np.pi * (i + 0.5) / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append([radius * np.sin(th) * np.cos(ph),
                          radius * np.cos(th),
                          radius * np.sin(th) * np.sin(ph)])
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = a + n_lon, b + n_lon
            faces += [[a, b, c], [b, d, c]]
    verts = np.asarray(verts)
    rng = np.random.default_rng(seed)
    parents = params.SMPL_PARENTS
    joints = np.zeros((24, 3))
    for i in range(1, 24):
        d = rng.normal(size=3)
        joints[i] = joints[parents[i]] + d / np.linalg.norm(d) * 0.08
    dist = np.linalg.norm(verts[:, None] - joints[None], axis=-1)
    w = np.exp(-dist / 0.05)
    w /= w.sum(1, keepdims=True)
    return rigging.avatar_from_numpy(
        v_template=verts, weights=w, color=np.full_like(verts, 0.6),
        faces=np.asarray(faces), joints=joints, parents=parents)


def clip(seed=0):
    from tpubody_torch.io import motion

    rng = np.random.default_rng(seed)
    return motion.MotionClip(
        poses=0.1 * rng.normal(size=(CLIP_FRAMES, 24, 3)),
        trans=np.zeros((CLIP_FRAMES, 3)), fps=10.0)


def render_kwargs():
    return dict(cam_t=np.array([0.0, 0.0, 3.0]), size=SIZE, focal=100.0,
                chunk=2, window=SIZE)


def record_writer(frames: list):
    """Make VideoWriter.write also append each frame (uint8) to
    ``frames``."""
    from tpubody_torch.render import video

    write = video.VideoWriter.write

    def recording(self, frame):
        frames.append(video.quantize_u8(np.asarray(frame)).copy())
        write(self, frame)
    video.VideoWriter.write = recording


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    port, outdir = sys.argv[3], pathlib.Path(sys.argv[4])
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from tpubody_torch.dist import multihost
    from tpubody_torch.pipelines import animate

    ok = multihost.initialize(f"localhost:{port}", world, rank,
                              backend="gloo", timeout_s=120.0)
    assert ok, "initialize() returned False with an explicit coordinator"
    assert multihost.process_count() == world
    assert multihost.process_index() == rank
    mesh = multihost.global_mesh(device="cpu")

    full = np.arange(N_FRAMES * 5 * 3, dtype=np.float32).reshape(
        N_FRAMES, 5, 3)
    start, stop = multihost.process_frame_slice(N_FRAMES)
    garr = multihost.global_frames_array(full[start:stop], mesh)
    assert garr.shape == (N_FRAMES, 5, 3) and garr.offset == start
    local = garr.gather()
    total = local.sum(dtype=torch.float64)
    dist.all_reduce(total)
    np.save(outdir / f"out_{rank}.npy",
            multihost.gather_frames_to_host(local * 2.0 + 1.0))
    np.save(outdir / f"mean_{rank}.npy", (total / full.size).numpy())
    np.save(outdir / f"slice_{rank}.npy", np.asarray([start, stop]))

    frames: list = []
    record_writer(frames)
    out = animate.animate_video(sphere_avatar(), clip(),
                                str(outdir / "clip.mp4"), multihost=True,
                                device="cpu", **render_kwargs())
    assert out == str(outdir / "clip.mp4")
    if rank == 0:
        np.save(outdir / "frames_0.npy", np.stack(frames))
    else:
        assert not frames, "only process 0 writes the MP4"
    dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
