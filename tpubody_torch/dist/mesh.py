"""Device mesh and frame-axis sharding helpers (port of
``tpubody.dist.mesh``).

The natural parallel axis of this workload is *frames* (animation clips
are hundreds of frames, HMR batches are images).  PyTorch has no
single-controller SPMD, so a sharded call here is one launch sequence per
shard, each on its own device, then a concatenation:

  * :func:`make_mesh` — a 1-D :class:`Mesh` over the CUDA devices (or an
    explicit device list, which may name a device more than once: the
    counterpart of XLA's forced host device count, e.g. 8 shards on the
    CPU or 2 on one card),
  * :func:`frames_sharding` / :func:`replicated` — sharding descriptors
    that ``InferenceServer`` and ``DeviceLoader`` take,
  * :func:`pad_frames` — round the frame axis up to a multiple of the
    mesh size (repeat-last; callers slice the result back),
  * :func:`shard_frames` — split every tensor of a tree into equal
    per-device pieces (a :class:`Sharded`, gathered by ``gather``),
  * :func:`replicate` — one copy of a tensor tree, a module or a step per
    device of the mesh (devices named twice share one copy).

Work on a shard runs under :func:`on_device`, so a kernel launched through
``ctypes`` finds the shard's device current.  The shards of a call are
launched one after another from the calling thread: on distinct cards
their kernels overlap, on one card listed twice they queue on its stream.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve

FRAMES_AXIS = "frames"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D list of devices over the frame axis.  ``devices`` are this
    process's devices, one per shard; ``process_index`` and
    ``process_count`` place them in a multi-process run
    (``dist.multihost.global_mesh``; 0 and 1 in one process)."""

    devices: Tuple[torch.device, ...]
    axis: str = FRAMES_AXIS
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size * self.process_count}

    def distinct(self) -> List[torch.device]:
        """The devices in order of first appearance, each once."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, axis: str = FRAMES_AXIS,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (default: all),
    or over ``devices`` as given (a device may be listed more than once).
    Raises if more devices are asked for than exist."""
    if devices is not None:
        devs = tuple(canonical(resolve(d)) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return Mesh(devs, axis)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "make_mesh() spans the CUDA devices and none is present; pass "
            "devices=[...] (e.g. ['cpu'] * 8) for an explicit mesh")
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh({n_devices}): {count} CUDA devices "
                         f"present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


class FramesSharding(NamedTuple):
    """Leading (frame) axis split over ``mesh``; trailing dims whole."""

    mesh: Mesh


class Replicated(NamedTuple):
    """A whole copy on every device of ``mesh``."""

    mesh: Mesh


def frames_sharding(mesh: Mesh, axis: str = FRAMES_AXIS) -> FramesSharding:
    """Shard the leading (frame) axis over the mesh."""
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    return FramesSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    """Fully replicated (model parameters, small metadata)."""
    return Replicated(mesh)


def canonical(device: DeviceLike) -> torch.device:
    """``device`` with its index: bare "cuda" is the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def on_device(device: torch.device) -> Iterator[None]:
    """Make ``device`` the current CUDA device inside the block (nothing
    for the CPU)."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


class Sharded:
    """A frame-sharded array: ``shards[i]`` lives on ``mesh.devices[i]``,
    all with the same leading length.  ``offset`` is the global index of
    the first frame of ``shards[0]`` and ``global_len`` the length of the
    whole frame axis (other processes hold the rest in a multi-process
    run; in one process ``offset`` is 0 and ``global_len`` the sum)."""

    __slots__ = ("shards", "mesh", "offset", "global_len")

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh,
                 offset: int = 0, global_len: Optional[int] = None):
        self.shards = tuple(shards)
        self.mesh = mesh
        self.offset = offset
        self.global_len = (sum(s.shape[0] for s in self.shards)
                           if global_len is None else global_len)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.global_len, *self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self, device: Optional[DeviceLike] = None) -> torch.Tensor:
        """This process's shards concatenated in order on ``device``
        (default: the first shard's)."""
        dev = self.shards[0].device if device is None else resolve(device)
        return torch.cat([s.to(dev) for s in self.shards], dim=0)


def _tree_map(fn, tree):
    """``fn`` on every leaf of a dict / list / tuple / NamedTuple tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pad_frames(x, n_shards: int):
    """Pad the leading axis of a tensor or array to a multiple of
    ``n_shards`` by repeating its last frame."""
    rem = (-x.shape[0]) % n_shards
    if rem == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(rem, *x.shape[1:])], dim=0)
    return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)


def split_frames(x, n_shards: int) -> list:
    """The leading axis of a tensor or array in ``n_shards`` equal pieces;
    raises ``ValueError`` if it does not divide."""
    if x.shape[0] % n_shards:
        raise ValueError(f"frame count {x.shape[0]} not divisible by "
                         f"{n_shards} shards; pad with pad_frames")
    per = x.shape[0] // n_shards
    return [x[i * per:(i + 1) * per] for i in range(n_shards)]


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array or list as a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))


def shard_frames(tree, mesh: Mesh):
    """Every tensor or array in ``tree`` split along its leading axis into
    one piece per device of the mesh, each copied there -> the same tree
    of :class:`Sharded`."""
    def put(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        return Sharded([as_tensor(p).to(d) for p, d in
                        zip(split_frames(x, mesh.size), mesh.devices)], mesh)
    return _tree_map(put, tree)


def copy_to(tree, device: torch.device):
    """One copy of ``tree`` on ``device``, leaf by leaf: a tensor or array
    (as a tensor), a module (a deep copy; ``Module.to`` moves in place), an
    object with a ``to(device)`` method that returns a copy (the port's
    body models, serving steps and int8 records).  Any other leaf (a plain
    function) is kept as it is."""
    def leaf(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return as_tensor(x).to(device)
        if isinstance(x, torch.nn.Module):
            return copy.deepcopy(x).to(device)
        if callable(getattr(x, "to", None)):
            return x.to(device)
        return x
    return _tree_map(leaf, tree)


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per device of the mesh (see :func:`copy_to`),
    in mesh order; devices listed more than once share one copy."""
    copies = {d: copy_to(tree, d) for d in mesh.distinct()}
    return [copies[d] for d in mesh.devices]
