"""Multi-process frame sharding on ``torch.distributed`` (port of
``tpubody.dist.multihost``).

  * :func:`initialize` — join the process group (``init_process_group``
    with ``tcp://<coordinator>``, world size and rank); a no-op returning
    False when there is nothing to join,
  * :func:`global_mesh` — this process's devices, placed in the run,
  * :func:`process_frame_slice` — the contiguous frame range this process
    loads (no process materialises the whole clip),
  * :func:`global_frames_array` — this process's frames split over its
    devices, with the global shape and its offset in it,
  * :func:`gather_frames_to_host` — every process's frames, in process
    order, on every process's host (the video-assembly boundary: the MP4
    mux is host-side).

The backend is the caller's choice, never switched behind its back: NCCL
for one process per GPU (its collectives take CUDA tensors), gloo for the
CPU or for processes that share one card (NCCL admits one rank a GPU).
Gloo's ``all_gather`` takes host tensors, so a gather under gloo copies to
the host first; that is where ``tpubody``'s ``process_allgather`` lands
too.  Single-process callers can use everything here unchanged.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.dist import mesh as mesh_lib

FRAMES_AXIS = mesh_lib.FRAMES_AXIS
BACKENDS = ("nccl", "gloo")
CLUSTER_KEYS = ("COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
                "TPU_WORKER_HOSTNAMES", "SLURM_JOB_ID")

# The CUDA devices given to initialize(local_device_ids=...): a process's
# place in the run, like torch.distributed's own process group.
_LOCAL_DEVICES: Optional[Tuple[torch.device, ...]] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: str = "nccl",
               timeout_s: float = 300.0) -> bool:
    """Join the process group; returns True if distributed.

    No-op (False) when there is nothing to join: no coordinator given (nor
    in ``TPUBODY_COORDINATOR``) and no cluster environment detected.
    ``coordinator_address`` is ``host:port`` of rank 0; without one (in a
    cluster) the group reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (``env://``).  ``local_device_ids``: the
    CUDA devices of this process (the first becomes current).
    ``backend``: "nccl" or "gloo" (module docstring)."""
    global _LOCAL_DEVICES
    if coordinator_address is None:
        coordinator_address = os.environ.get("TPUBODY_COORDINATOR")
    in_cluster = any(os.environ.get(k) for k in CLUSTER_KEYS)
    if coordinator_address is None and not in_cluster:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs CUDA devices; pass "
                           "backend='gloo' for processes on the CPU")
    if local_device_ids is not None:
        _LOCAL_DEVICES = tuple(torch.device("cuda", int(i))
                               for i in local_device_ids)
        torch.cuda.set_device(_LOCAL_DEVICES[0])
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis: str = FRAMES_AXIS,
                device: DeviceLike = "cuda") -> mesh_lib.Mesh:
    """This process's part of the frames mesh: the devices given to
    :func:`initialize` (else ``device``; "cuda" is the current CUDA
    device), with its process index and the process count."""
    if _LOCAL_DEVICES is not None:
        devices = _LOCAL_DEVICES
    else:
        devices = (mesh_lib.canonical(resolve(device)),)
    return mesh_lib.Mesh(tuple(devices), axis, process_index(),
                         process_count())


def process_frame_slice(n_frames: int,
                        process_id: Optional[int] = None,
                        n_processes: Optional[int] = None
                        ) -> Tuple[int, int]:
    """[start, stop) frame range this process loads.

    Frames are padded logically to a multiple of the process count (the
    last process's range is clamped; pair with ``dist.mesh.pad_frames`` on
    the shard if the computation needs equal lengths)."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if n_processes is None else n_processes
    per = -(-n_frames // n)          # ceil
    start = min(pid * per, n_frames)
    stop = min(start + per, n_frames)
    return start, stop


def global_frames_array(local_frames, mesh: mesh_lib.Mesh
                        ) -> mesh_lib.Sharded:
    """This process's ``process_frame_slice`` of frames -> its part of the
    global frames-sharded array: split over its devices, with the global
    length and its offset.  Every process must pass the same length,
    divisible by its device count (pad with ``dist.mesh.pad_frames``
    first; callers slice the padding off after gathering)."""
    local = mesh_lib.as_tensor(local_frames)
    n_local = mesh.size
    if local.shape[0] % n_local:
        raise ValueError(
            f"local frame count {local.shape[0]} not divisible by local "
            f"device count {n_local}; pad with dist.mesh.pad_frames")
    pieces = mesh_lib.split_frames(local, n_local)
    return mesh_lib.Sharded(
        [p.to(d) for p, d in zip(pieces, mesh.devices)], mesh,
        offset=mesh.process_index * local.shape[0],
        global_len=local.shape[0] * mesh.process_count)


def gather_frames_to_host(x) -> np.ndarray:
    """Every process's frames (a :class:`~dist.mesh.Sharded`, a tensor or
    an array of this process's part), concatenated in process order, as
    numpy on every process.  At world size 1 this process's part."""
    if isinstance(x, mesh_lib.Sharded):
        x = x.gather()
    x = mesh_lib.as_tensor(x)
    if process_count() == 1:
        return x.cpu().numpy()
    if dist.get_backend() == "nccl":
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        x = x.cpu()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=0).cpu().numpy()
