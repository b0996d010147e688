"""Online inference serving: dynamic micro-batching onto one step (port of
``tpubody.pipelines.serving``).

  * Requests pad up to a small fixed set of batch sizes (buckets), so the
    step sees few distinct shapes (one cuDNN plan per bucket, warmed up
    front).
  * The batcher takes whatever is already queued, then coalesces until
    the largest bucket is full or the oldest request has waited
    ``max_delay_ms``.
  * Clients submit from any thread; one dispatch thread owns the device.

:func:`hmr_smpl_step` builds the flagship images -> (verts, cam) step,
:func:`keypoint_step` the images -> (keypoints, confidences) step.
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
from tpubody_torch.utils.profiling import span


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
# When HMRSMPLStep pipelines its copy in, a chunk holds the largest power of
# two of frames, up to CHUNK_FRAMES, whose float32 frames fit CHUNK_BYTES;
# the step chunks a host batch of at least two such chunks.
CHUNK_FRAMES = 256
CHUNK_BYTES = 256 << 20


def chunk_frames(frame_shape: Sequence[int]) -> int:
    """The frames of a copy chunk for frames of ``frame_shape`` (no batch
    dim), by the rule above; at least 1."""
    frame = 4 * int(np.prod(frame_shape))
    n = CHUNK_FRAMES
    while n > 1 and n * frame > CHUNK_BYTES:
        n //= 2
    return n


class CopyInStep:
    """The copy in that the served steps share: a step holds ``device``
    and runs its model's frame-by-frame ``backbone`` (:meth:`_backbone`)
    on the images it is given.

    A chunk is sized by a frame's bytes (:func:`chunk_frames`: the largest
    power of two of frames, up to ``CHUNK_FRAMES``, whose float32 frames
    fit ``CHUNK_BYTES``).  A batch in host memory of at least two chunks,
    on a CUDA step, is copied in chunk by chunk on a side stream while the
    card runs the backbone on the chunk before (the last chunk may be
    ragged); any other batch is copied in one piece.  Each copy is a span
    ``step.h2d``."""

    device: torch.device

    def _backbone(self, images: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _chunks(self, images) -> int:
        """How many pieces the step copies ``images`` in: ceil(B / chunk),
        the chunk :func:`chunk_frames` of a frame, on CUDA for a host batch
        of at least two chunks, else 1."""
        on_host = (not isinstance(images, torch.Tensor)
                   or images.device.type == "cpu")
        if self.device.type != "cuda" or not on_host:
            return 1
        chunk = chunk_frames(np.shape(images)[1:])
        if len(images) < 2 * chunk:
            return 1
        return -(-len(images) // chunk)

    def _backbone_in_chunks(self, images, chunk: int) -> torch.Tensor:
        """The backbone's features of a host batch, copied in ``chunk``
        frames at a time.  On CUDA each chunk's copy runs on a side stream
        (a span ``step.h2d`` each, its events on that stream) and the
        compute stream waits for it before the chunk's backbone; that
        backbone is queued before the host starts the next copy, which
        holds the host until a pageable source is staged.  Nothing waits
        on the host."""
        host = torch.as_tensor(images, dtype=torch.float32)
        batch = torch.empty(host.shape, dtype=torch.float32,
                            device=self.device)
        cuda = self.device.type == "cuda"
        copy = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            compute = torch.cuda.current_stream(self.device)
            copy.wait_stream(compute)        # batch's memory is free there
        features = []
        for a in range(0, len(host), chunk):
            part = slice(a, a + chunk)
            with torch.cuda.stream(copy), span("step.h2d"):
                batch[part].copy_(host[part], non_blocking=True)
            if cuda:
                compute.wait_event(copy.record_event())
            features.append(self._backbone(batch[part]))
        return torch.cat(features)

    def _copy_in_backbone(self, images) -> torch.Tensor:
        """The backbone's features of ``images``, copied in by the rule
        above; call it inside the step's span."""
        if self._chunks(images) > 1:
            return self._backbone_in_chunks(
                images, chunk_frames(np.shape(images)[1:]))
        with span("step.h2d"):
            images = torch.as_tensor(images, dtype=torch.float32,
                                     device=self.device)
        return self._backbone(images)


class HMRSMPLStep(CopyInStep):
    """images (B, H, W, 3) float32 NHWC -> (posed verts (B, V, 3) fp32,
    weak-perspective cam (B, 3) fp32).  ``hmr`` (the HMR module, HMR 2.0's,
    the int8 ``hmr_quant.QuantizedHMR`` or Multi-HMR's: each
    ``head(backbone(images))``) and ``body`` are on ``device``;
    ``image_shape`` is one request's input shape.  ``to(device)`` is a
    replica on another device (a sharded server makes one a device).

    A model of several persons a frame (Multi-HMR: ``hmr.persons`` P, its
    ``cam`` the point where joint ``hmr.anchor_joint`` goes) answers
    (posed verts (B, P, V, 3), translation (B, P, 3)): each body's
    translation puts that joint of the posed body at the point, and goes
    into the LBS with the body.

    The images go in by :class:`CopyInStep`'s rule (every backbone works
    frame by frame); the head and the LBS then run once on the whole
    batch."""

    def __init__(self, hmr, body, device: DeviceLike, image_size: int):
        self.hmr = hmr
        self.body = body
        self.device = torch.device(device)
        self.image_shape = (image_size, image_size, 3)

    def to(self, device: DeviceLike) -> "HMRSMPLStep":
        from tpubody_torch.dist import mesh as mesh_lib

        dev = resolve(device)
        return HMRSMPLStep(mesh_lib.copy_to(self.hmr, dev),
                           self.body.to(dev), dev, self.image_shape[0])

    def _backbone(self, images: torch.Tensor) -> torch.Tensor:
        return self.hmr.backbone(images)

    @torch.inference_mode()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        from tpubody_torch.models import smpl as smpl_lib

        with span("step"):
            features = self._copy_in_backbone(images)
            out = self.hmr.head(features)
            persons = getattr(self.hmr, "persons", None)
            if persons is None:
                verts = smpl_lib.forward_batch_verts(
                    self.body, out.rotmats, out.shape, None,
                    pose_is_rotmat=True)
                return verts, out.cam
            verts, transl = smpl_lib.forward_batch_placed(
                self.body, out.rotmats, out.shape, self.hmr.anchor_joint,
                out.cam)
        return (verts.view(-1, persons, *verts.shape[1:]),
                transl.view(-1, persons, 3))


class KeypointStep(CopyInStep):
    """images (B, S, S, 3) float32 NHWC -> (keypoints (B, K, 2) in the
    frames' pixels, confidences (B, K)), float32.  ``model`` (Sapiens pose,
    ``models/sapiens.py``: ``head(backbone(images))`` heatmap logits and
    ``decode(logits)``) is on ``device``; ``image_size`` is S.

    The images go in by :class:`CopyInStep`'s rule; the head and the
    decode then run once on the whole batch."""

    def __init__(self, model, device: DeviceLike, image_size: int):
        self.model = model
        self.device = torch.device(device)
        self.image_shape = (image_size, image_size, 3)

    def to(self, device: DeviceLike) -> "KeypointStep":
        from tpubody_torch.dist import mesh as mesh_lib

        dev = resolve(device)
        return KeypointStep(mesh_lib.copy_to(self.model, dev), dev,
                            self.image_shape[0])

    def _backbone(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.backbone(images)

    @torch.inference_mode()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("step"):
            features = self._copy_in_backbone(images)
            return self.model.decode(self.model.head(features))


ARCHS = ("hmr_r50", "hmr2_vith", "multihmr_896_l")


def hmr_smpl_step(dtype: torch.dtype = torch.bfloat16,
                  n_joints: Optional[int] = None,
                  n_verts: Optional[int] = None, stem: str = "conv7",
                  image_size: Optional[int] = None, quantize: bool = False,
                  calib_images=None, device: DeviceLike = "cuda",
                  arch: str = "hmr_r50",
                  mean_params: Optional[np.ndarray] = None) -> HMRSMPLStep:
    """The flagship serving step: images -> (posed verts, weak-persp cam),
    a regressor (seeded random weights) then the body model's batched LBS,
    which on CUDA is the fused LBS kernel.

    ``arch``: "hmr_r50", HMR (ResNet-50 + IEF, ``models/hmr``; ``stem``
    picks its first convolution), "hmr2_vith", HMR 2.0 (ViT-H/16 and a
    cross-attention decoder, ``models/hmr2``), which takes 256^2 images,
    or "multihmr_896_l", Multi-HMR (DINOv2 ViT-L/14 and a cross-attention
    head, ``models/multihmr``), which takes 896^2 images and answers 8
    SMPL-X bodies a frame.  The body: ``load_or_synthetic`` SMPL at
    ``n_joints`` 24 and ``n_verts`` 6890 by default, SMPL-X at 55 and
    10475 for Multi-HMR.  ``image_size`` defaults to the architecture's
    (the transformers take no other).
    ``mean_params``: the regressor's start, the 6D pose as
    ``rot6d_to_rotmat`` reads it: (144 + 10 + 3,) by default
    ``hmr.default_mean_params()`` (``tpubody``'s) for HMR and
    ``hmr.identity_mean_params()`` for HMR 2.0; (318 + 10 + 3,)
    ``multihmr.default_mean_params()`` for Multi-HMR.

    ``quantize=True`` serves the int8 PTQ backbone (``models/hmr_quant``:
    the HMR built in float32, BatchNorm folded, per-channel weight and
    calibrated activation scales) instead of the ``dtype`` forward.  Pass
    real ``calib_images`` for a production deployment; the default, 4
    seeded images (numpy's ``default_rng(0)``, normal at scale 0.5, as in
    ``tpubody``), is a throughput-benchmark stand-in."""
    from tpubody_torch.models import hmr as hmr_lib
    from tpubody_torch.models import params as params_lib

    if arch not in ARCHS:
        raise ValueError(f"arch={arch!r}: expected one of {ARCHS}")
    if quantize and arch != "hmr_r50":
        raise NotImplementedError(
            f"quantize=True: the int8 path (models/hmr_quant) quantizes "
            f"HMR's ResNet-50 only, not {arch}")
    dev = resolve(device)
    if arch in ("hmr2_vith", "multihmr_896_l"):
        if arch == "hmr2_vith":
            from tpubody_torch.models import hmr2 as lib

            model = lib.create_hmr2(mean_params, dtype=dtype, device=dev)
        else:
            from tpubody_torch.models import multihmr as lib

            model = lib.create_multihmr(mean_params, dtype=dtype, device=dev)
            if n_joints not in (None, lib.N_JOINTS):
                raise ValueError(f"n_joints={n_joints}: Multi-HMR poses "
                                 f"SMPL-X's {lib.N_JOINTS} joints")
            n_joints = lib.N_JOINTS
        if image_size not in (None, model.image_size):
            raise ValueError(f"image_size={image_size}: {arch} takes "
                             f"{model.image_size}^2 images")
        image_size = model.image_size
    else:
        image_size = image_size or 224
        model = hmr_lib.create_hmr(
            mean_params, dtype=torch.float32 if quantize else dtype,
            stem=stem, device=dev)
    kind, full = (("smplx", params_lib.SMPLX_NUM_VERTS)
                  if arch == "multihmr_896_l"
                  else ("smpl", params_lib.SMPL_NUM_VERTS))
    n_verts = n_verts or full
    body = params_lib.load_or_synthetic(
        kind, n_joints=n_joints or 24, n_verts=n_verts, seed=0,
        warn=n_verts == full, device=dev)
    if quantize:
        from tpubody_torch.models import hmr_quant

        if calib_images is None:
            calib_images = np.random.default_rng(0).normal(
                scale=0.5, size=(4, image_size, image_size, 3)).astype(
                    np.float32)
        model = hmr_quant.QuantizedHMR(
            hmr_quant.quantize_hmr(model, calib_images),
            mean_params=mean_params)
    return HMRSMPLStep(model, body, dev, image_size)


KEYPOINT_ARCHS = ("sapiens_2b_pose",)


def keypoint_step(arch: str = "sapiens_2b_pose",
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = "cuda") -> KeypointStep:
    """The keypoint serving step: images -> (keypoints (B, K, 2) in the
    frames' pixels, confidences (B, K)), a heatmap model with seeded
    random weights.

    ``arch``: "sapiens_2b_pose", Sapiens-2B pose (``models/sapiens``: a
    ViT of 1,920 x 48 over the middle 1024 x 768 of 1024^2 frames, a
    deconvolution heatmap head), 308 keypoints; its ``dtype`` compute
    precision.  On CUDA the model takes no autograd (the step runs in
    inference mode)."""
    if arch not in KEYPOINT_ARCHS:
        raise ValueError(f"arch={arch!r}: expected one of {KEYPOINT_ARCHS}")
    from tpubody_torch.models import sapiens

    dev = resolve(device)
    model = sapiens.create_sapiens_pose(dtype=dtype, device=dev)
    return KeypointStep(model, dev, model.image_size)


class FitSMPLHStep:
    """Fitting as a service: a batch of keypoint requests {"keypoints" (B,
    n_kp, 3), "center" (B, 2)} -> ``BatchFitter.apply``'s per-lane dict
    {"pose", "shape", "cam_t", "emb", "loss", "expression"}.  The fit
    differentiates its objective, so the step leaves inference mode (the
    server warms up under it) and works on its own copies of the
    requests."""

    def __init__(self, fitter):
        self.fitter = fitter

    def to(self, device: DeviceLike) -> "FitSMPLHStep":
        return FitSMPLHStep(self.fitter.replica(device))

    def __call__(self, req):
        with torch.inference_mode(False):
            return self.fitter.apply(req["keypoints"].clone(),
                                     req["center"].clone())


def fit_smplh_step(model=None, config=None, dec_params=None,
                   device: DeviceLike = "cuda"):
    """Fitting-as-a-service: keypoint requests -> staged SMPLH fits.

    Returns ``(step, request_spec)`` for :class:`InferenceServer`: each
    request is ``{"keypoints": (n_kp, 3) f32, "center": (2,) f32}`` (the
    OpenPose layout fit.keypoints reads) and each response slice is the
    per-request dict ``{"pose" (156,), "shape" (10,), "cam_t" (3,),
    "emb" (32,), "loss" (), "expression"}``.

    Keep ``buckets`` SMALL (e.g. ``(4,)``): the server's warm-up runs one
    whole fit per bucket."""
    from tpubody_torch.fit import smplify
    from tpubody_torch.pipelines import gen_smplh as gen_lib

    dev = resolve(device)
    config = config or smplify.FitConfig()
    model = model if model is not None else gen_lib.default_fit_model(
        config, device=dev)
    fitter = smplify.BatchFitter(model, config, dec_params=dec_params,
                                 device=dev)
    # Keypoint-row contract per family: BODY_25 + hands + SMPL-X face rows
    # (the layout fit.keypoints.read_openpose_json/joint_weights use).
    n_kp = 25
    if model.num_joints in (52, 55) and config.use_hands:
        n_kp += 42
    if model.num_joints == 55 and config.use_face:
        n_kp += 51 + 17 * config.use_face_contour
    spec = {"keypoints": TensorSpec((n_kp, 3), np.float32),
            "center": TensorSpec((2,), np.float32)}
    return FitSMPLHStep(fitter), spec


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
    device: where batches are placed and the step runs (without
        ``sharding``).
    sharding: ``dist.mesh.frames_sharding(mesh)``: every bucket must
        divide by the mesh size; each batch is split over the mesh and
        the step runs once a shard, on a replica of the step on that
        shard's device (``dist.mesh.replicate``: a step with a
        ``to(device)`` method, as the port's steps have, is copied there;
        a plain function is called as it is), then the outputs are
        concatenated in shard order.
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
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.sharding = sharding
        if sharding is not None:
            from tpubody_torch.dist import mesh as mesh_lib

            if not isinstance(sharding, mesh_lib.FramesSharding):
                raise TypeError("sharding must be dist.mesh.frames_sharding"
                                f"(mesh), not {type(sharding).__name__}")
            mesh = sharding.mesh
            bad = [b for b in self.buckets if b % mesh.size]
            if bad:
                raise ValueError(
                    f"buckets {bad} not divisible by mesh size {mesh.size}")
            self.device = mesh.devices[0]
            self._replicas = mesh_lib.replicate(step, mesh)
        else:
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
    def _put(self, batch_tree, device):
        return _tree_map(lambda a: torch.from_numpy(a).to(device),
                         batch_tree)

    def _run(self, batch_tree) -> list:
        """The step on a host batch -> one output tree per shard (one in
        all without sharding)."""
        if self.sharding is None:
            return [self._step(self._put(batch_tree, self.device))]
        from tpubody_torch.dist import mesh as mesh_lib

        mesh = self.sharding.mesh
        leaves, structure = _flatten(batch_tree)
        pieces = [mesh_lib.split_frames(a, mesh.size) for a in leaves]
        outs = []
        for i, dev in enumerate(mesh.devices):
            shard = _unflatten(structure, [p[i] for p in pieces])
            with mesh_lib.on_device(dev):
                outs.append(self._replicas[i](self._put(shard, dev)))
        return outs

    def _zeros_batch(self, bucket: int):
        return _unflatten(self._spec_struct, [
            np.zeros((bucket,) + tuple(l.shape), l.dtype)
            for l in self._spec_leaves])

    def _sync(self) -> None:
        devices = (self.sharding.mesh.distinct() if self.sharding is not None
                   else [self.device])
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def warmup(self) -> None:
        """Run every bucket once up front, so no request pays first-call
        costs (kernel build, cuDNN plan selection)."""
        with torch.inference_mode():
            for b in self.buckets:
                self._run(self._zeros_batch(b))
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
            outs = self._run(batch_tree)
            if self.to_host:
                outs = [_tree_map(_to_numpy, o) for o in outs]
                if len(outs) > 1:          # shards, in order
                    structure = _flatten(outs[0])[1]
                    outs = [_unflatten(structure, [
                        np.concatenate(parts) for parts in
                        zip(*(_flatten(o)[0] for o in outs))])]
            else:
                self._sync()
        except Exception as e:  # the loop must keep serving; report per request
            print(f"InferenceServer: step failed: {e!r}", file=sys.stderr)
            for r in batch:
                r.future.set_exception(e)
            return
        t_done = time.perf_counter()
        per = bucket // len(outs)            # rows a shard
        for i, r in enumerate(batch):
            r.future.set_result(_tree_map(lambda a, i=i: a[i % per],
                                          outs[i // per]))
        self.stats.record(n, bucket - n,
                          [t_done - r.t_submit for r in batch])
