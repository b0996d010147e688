"""tpubody_torch.dist.multihost against tpubody.dist.multihost.

The single-process helpers run in this process (frame slices equal to
tpubody's, the global array over an explicit 8-shard CPU mesh).  The
two-process run spawns tests/torch_multihost_worker.py twice, joined by
torch.distributed with gloo on the CPU at tcp://localhost, as
tests/test_multihost.py spawns its JAX workers: the processes load
disjoint halves, the gathered frames and the mean by all_reduce are
exact, and animate_video(multihost=True) at 64^2, 8 frames, has process 0
write the MP4 with frames equal to the single-process ones (the same
renderer on the same frames: bit for bit).
"""
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_multihost_worker as worker
from tpubody.dist import multihost as jmultihost
from tpubody_torch.dist import mesh as tmesh
from tpubody_torch.dist import multihost as tmultihost

torch.set_num_threads(1)

WORKER = pathlib.Path(__file__).parent / "torch_multihost_worker.py"
ENV_KEYS = ("TPUBODY_COORDINATOR",) + tmultihost.CLUSTER_KEYS


def cpu_mesh(n=8):
    return tmesh.make_mesh(devices=["cpu"] * n)


def test_initialize_noop_without_cluster(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert tmultihost.initialize() is False
    assert tmultihost.process_index() == 0
    assert tmultihost.process_count() == 1


def test_initialize_states_its_backend(monkeypatch):
    """An unknown backend raises; NCCL without CUDA raises instead of
    falling back to gloo."""
    with pytest.raises(ValueError, match="backend"):
        tmultihost.initialize("localhost:1", 1, 0, backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gloo"):
            tmultihost.initialize("localhost:1", 1, 0, backend="nccl")
    monkeypatch.setenv("TPUBODY_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="backend"):
        tmultihost.initialize(backend="mpi")


@pytest.mark.parametrize("n_frames,n_proc", [(10, 4), (24, 2), (7, 3),
                                             (2, 4), (0, 2)])
def test_process_frame_slice_matches_tpubody(n_frames, n_proc):
    slices = [tmultihost.process_frame_slice(n_frames, pid, n_proc)
              for pid in range(n_proc)]
    assert slices == [jmultihost.process_frame_slice(n_frames, pid, n_proc)
                      for pid in range(n_proc)]
    covered = [f for s, e in slices for f in range(s, e)]
    assert covered == list(range(n_frames))


def test_global_frames_array_single_process():
    mesh = cpu_mesh()
    data = np.arange(8 * 2 * 3, dtype=np.float32).reshape(16, 3)
    arr = tmultihost.global_frames_array(data, mesh)
    assert arr.shape == (16, 3) and arr.offset == 0
    assert len(arr.shards) == 8 and all(s.shape == (2, 3)
                                        for s in arr.shards)
    np.testing.assert_array_equal(arr.gather().numpy(), data)
    np.testing.assert_array_equal(tmultihost.gather_frames_to_host(arr),
                                  data)


def test_global_frames_array_rejects_ragged():
    with pytest.raises(ValueError, match="pad_frames"):
        tmultihost.global_frames_array(np.zeros((9, 3), np.float32),
                                       cpu_mesh())


def test_gather_passthrough():
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(tmultihost.gather_frames_to_host(x),
                                  x.numpy())


def test_global_mesh_single_process():
    mesh = tmultihost.global_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),)
    assert (mesh.process_index, mesh.process_count) == (0, 1)
    assert mesh.shape == {"frames": 1}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_shard_gather_and_mux(tmp_path):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(rank), "2", str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)

    full = np.arange(worker.N_FRAMES * 5 * 3, dtype=np.float32).reshape(
        worker.N_FRAMES, 5, 3)
    for rank in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out_{rank}.npy"),
                                      full * 2.0 + 1.0)
        np.testing.assert_allclose(np.load(tmp_path / f"mean_{rank}.npy"),
                                   full.astype(np.float64).mean(),
                                   rtol=1e-12)
    assert np.load(tmp_path / "slice_0.npy").tolist() == [0, 12]
    assert np.load(tmp_path / "slice_1.npy").tolist() == [12, 24]

    clip_path = tmp_path / "clip.mp4"
    assert clip_path.exists() and clip_path.stat().st_size > 300
    got = np.load(tmp_path / "frames_0.npy")
    assert got.shape == (worker.CLIP_FRAMES, worker.SIZE, worker.SIZE, 3)

    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import video

    frames = []
    write = video.VideoWriter.write
    try:
        worker.record_writer(frames)
        animate.animate_video(worker.sphere_avatar(), worker.clip(),
                              str(tmp_path / "single.mp4"), device="cpu",
                              **worker.render_kwargs())
    finally:
        video.VideoWriter.write = write
    np.testing.assert_array_equal(got, np.stack(frames))
    assert (got < 255).any(axis=-1).mean() > 0.05        # a body is there
