"""Online inference serving: dynamic micro-batching onto one step (port of
``tpubody.pipelines.serving``).

  * Requests pad up to a small fixed set of batch sizes (buckets), so the
    step sees few distinct shapes (one cuDNN plan per bucket, warmed up
    front).
  * The batcher takes whatever is already queued, then coalesces until
    the largest bucket is full or the oldest request has waited
    ``max_delay_ms``.
  * Clients submit from any thread; one dispatch thread owns the device.

:func:`hmr_smpl_step` builds the flagship images -> (verts, cam) step.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve


class TensorSpec(NamedTuple):
    """One request leaf: its shape (no batch dim) and numpy dtype."""

    shape: Tuple[int, ...]
    dtype: Any = np.float32


# -- minimal pytrees (dict / list / tuple / namedtuple of leaves) -----------
def _flatten(tree) -> Tuple[list, Any]:
    if isinstance(tree, TensorSpec):
        return [tree], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                (dict, tuple(keys), tuple(s for _, s in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree), None, tuple(s for _, s in parts)))
    return [tree], None


def _unflatten(structure, leaves: list):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, children = s
        values = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, values))
        if kind in (list, tuple):
            return kind(values)
        return kind(*values)          # namedtuple
    return build(structure)


def _tree_map(fn, tree):
    leaves, structure = _flatten(tree)
    return _unflatten(structure, [fn(x) for x in leaves])


def _to_numpy(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


# -- the flagship step ------------------------------------------------------
class HMRSMPLStep:
    """images (B, H, W, 3) float32 NHWC -> (posed verts (B, V, 3) fp32,
    weak-perspective cam (B, 3) fp32).  ``hmr`` and ``body`` are the HMR
    module and the body model, both on ``device``; ``image_shape`` is one
    request's input shape."""

    def __init__(self, hmr, body, device: torch.device, image_size: int):
        self.hmr = hmr
        self.body = body
        self.device = device
        self.image_shape = (image_size, image_size, 3)

    @torch.inference_mode()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        from tpubody_torch.models import smpl as smpl_lib

        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        out = self.hmr(images)
        verts = smpl_lib.forward_batch_verts(
            self.body, out.rotmats, out.shape, None, pose_is_rotmat=True)
        return verts, out.cam


def hmr_smpl_step(dtype: torch.dtype = torch.bfloat16, n_joints: int = 24,
                  n_verts: int = 6890, stem: str = "conv7",
                  image_size: int = 224, quantize: bool = False,
                  calib_images=None,
                  device: DeviceLike = "cuda") -> HMRSMPLStep:
    """The flagship serving step: images -> (posed verts, weak-persp cam),
    HMR (seeded random weights) then the body model's batched LBS, which
    on CUDA is the fused LBS kernel.  The int8 ``quantize`` path is not
    ported yet."""
    if quantize or calib_images is not None:
        raise NotImplementedError("quantize=True (int8 HMR) is not ported")
    from tpubody_torch.models import hmr as hmr_lib
    from tpubody_torch.models import params as params_lib

    dev = resolve(device)
    model = hmr_lib.create_hmr(dtype=dtype, stem=stem, device=dev)
    body = params_lib.load_or_synthetic(
        "smpl", n_joints=n_joints, n_verts=n_verts, seed=0,
        warn=n_verts == 6890, device=dev)
    return HMRSMPLStep(model, body, dev, image_size)


def fit_smplh_step(*args, **kwargs):
    """Fitting-as-a-service waits for the port of the fitting slice."""
    raise NotImplementedError("fit_smplh_step is not ported yet")


# -- the server -------------------------------------------------------------
class ServerStats:
    """Thread-safe rolling serving statistics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.padded = 0          # wasted rows from bucket padding
        self._latencies: List[float] = []
        self._t0 = time.perf_counter()

    def record(self, n_real: int, n_padded: int, latencies: Sequence[float]):
        with self._lock:
            self.requests += n_real
            self.batches += 1
            self.padded += n_padded
            self._latencies.extend(latencies)
            if len(self._latencies) > 10000:
                self._latencies = self._latencies[-5000:]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            dt = time.perf_counter() - self._t0
            return {
                "requests": self.requests,
                "batches": self.batches,
                "padded_rows": self.padded,
                "throughput_rps": self.requests / dt if dt > 0 else 0.0,
                "latency_p50_ms": 1e3 * lat[len(lat) // 2] if lat else 0.0,
                "latency_p99_ms":
                    1e3 * lat[int(len(lat) * 0.99)] if lat else 0.0,
            }


class _Request:
    __slots__ = ("value", "future", "t_submit")

    def __init__(self, value):
        self.value = value                 # tree matching the server spec
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


_STOPPED = "InferenceServer stopped before this request was dispatched"


class InferenceServer:
    """Dynamic-batching server around one step.

    Parameters
    ----------
    step: batched request tree of tensors on ``device`` -> tree of tensors
        with a leading batch dim.
    buckets: allowed batch sizes (requests pad up to the smallest bucket
        that fits).
    max_delay_ms: longest the OLDEST queued request waits for coalescing
        before a smaller batch is dispatched.
    image_shape: per-request input shape (H, W, C) of the default
        single-image spec.
    request_spec: optional tree of :class:`TensorSpec` describing ONE
        request (no batch dim); requests are stacked per leaf.
    to_host: resolve futures to numpy (default), or to per-request slices
        of the device tensors (no device->host copy on the dispatch path).
    device: where batches are placed and the step runs.
    """

    def __init__(
        self,
        step: Callable,
        image_shape: Tuple[int, int, int] = (224, 224, 3),
        buckets: Sequence[int] = (1, 4, 16, 64, 256),
        max_delay_ms: float = 5.0,
        warmup: bool = True,
        sharding: Optional[Any] = None,
        to_host: bool = True,
        request_spec: Optional[Any] = None,
        device: DeviceLike = "cuda",
    ):
        if sharding is not None:
            raise NotImplementedError("sharding= waits for the port of dist")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.device = resolve(device)
        self.image_shape = tuple(image_shape)
        self.request_spec = (request_spec if request_spec is not None
                             else TensorSpec(self.image_shape, np.float32))
        self._spec_leaves, self._spec_struct = _flatten(self.request_spec)
        self.max_delay = max_delay_ms / 1e3
        self.to_host = to_host
        self._step = step
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self.stats = ServerStats()
        self._thread: Optional[threading.Thread] = None
        if warmup:
            self.warmup()

    # -- lifecycle -------------------------------------------------------
    def _put(self, batch_tree):
        return _tree_map(lambda a: torch.from_numpy(a).to(self.device),
                         batch_tree)

    def _zeros_batch(self, bucket: int):
        return _unflatten(self._spec_struct, [
            np.zeros((bucket,) + tuple(l.shape), l.dtype)
            for l in self._spec_leaves])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run every bucket once up front, so no request pays first-call
        costs (kernel build, cuDNN plan selection)."""
        with torch.inference_mode():
            for b in self.buckets:
                self._step(self._put(self._zeros_batch(b)))
        self._sync()

    def start(self) -> "InferenceServer":
        if self._thread is None:
            self.stats._t0 = time.perf_counter()  # exclude warmup
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def _fail_queued(self) -> None:
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.future.set_exception(RuntimeError(_STOPPED))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # Fail requests still queued (submitted but never dispatched) so no
        # client blocks forever on a future the loop will not serve.
        self._fail_queued()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ------------------------------------------------------
    def submit(self, value) -> Future:
        """Enqueue one request (a tree matching ``request_spec``; a bare
        image array under the default spec).  The Future resolves to this
        request's slice of the step's output tree."""
        leaves, structure = _flatten(value)
        if structure != self._spec_struct:
            raise ValueError(
                f"request structure {structure} != spec {self._spec_struct}")
        cast = []
        for leaf, spec in zip(leaves, self._spec_leaves):
            arr = np.asarray(leaf, spec.dtype)
            if arr.shape != tuple(spec.shape):
                raise ValueError(
                    f"expected leaf shape {tuple(spec.shape)}, "
                    f"got {arr.shape}")
            cast.append(arr)
        if self._stop.is_set():
            raise RuntimeError("InferenceServer is stopped")
        req = _Request(_unflatten(structure, cast))
        self._q.put(req)
        # Close the submit/stop race: if stop() finished its drain between
        # the check above and the put, fail the request here rather than
        # leave the caller blocked on its future.
        if self._stop.is_set() and self._thread is None:
            self._fail_queued()
        return req.future

    def __call__(self, value):
        """Synchronous convenience wrapper."""
        return self.submit(value).result()

    # -- dispatch loop ---------------------------------------------------
    def _gather(self) -> List[_Request]:
        """Block for the first request, drain whatever is already queued,
        then coalesce until the largest bucket is full or the oldest
        request's delay budget expires.  The greedy drain keeps batches
        large under sustained load, when queued requests have typically
        waited past ``max_delay`` already."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        max_b = self.buckets[-1]
        while len(batch) < max_b:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        deadline = first.t_submit + self.max_delay
        while len(batch) < max_b:
            remain = deadline - time.perf_counter()
            if remain <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remain))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        with torch.inference_mode():
            while not self._stop.is_set():
                batch = self._gather()
                if batch:
                    self._dispatch(batch)

    def _dispatch(self, batch: List[_Request]) -> None:
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        batch_tree = self._zeros_batch(bucket)
        batch_leaves, _ = _flatten(batch_tree)
        for i, r in enumerate(batch):
            for dst, src in zip(batch_leaves, _flatten(r.value)[0]):
                dst[i] = src
        try:
            out = self._step(self._put(batch_tree))
            if self.to_host:
                out = _tree_map(_to_numpy, out)
            else:
                self._sync()
        except Exception as e:  # the loop must keep serving; report per request
            print(f"InferenceServer: step failed: {e!r}", file=sys.stderr)
            for r in batch:
                r.future.set_exception(e)
            return
        t_done = time.perf_counter()
        for i, r in enumerate(batch):
            r.future.set_result(_tree_map(lambda a, i=i: a[i], out))
        self.stats.record(n, bucket - n,
                          [t_done - r.t_submit for r in batch])
