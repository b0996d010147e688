"""Training input pipeline: dataset -> augment -> collate -> device prefetch
(port of ``tpubody.io.dataset``).

  * :class:`HMRExample` / :class:`ArrayDataset` — a minimal indexable
    source of (image, 2D keypoints, optional SMPL ground truth),
  * :func:`preprocess_example` — HMR cropping (scale*200 box -> 224^2) +
    keypoint transform into the crop frame + ImageNet normalization,
  * :func:`random_flip` / :func:`jitter_scale` — standard HMR
    augmentations with left/right joint swaps and mirrored rotation
    targets,
  * :func:`collate` — list of examples -> one :class:`TrainBatch` of CPU
    tensors,
  * :class:`DeviceLoader` — a background thread that collates batches,
    pins them and copies them to the card on a side CUDA stream, keeping
    ``prefetch`` batches ahead of the training loop.

The host side is numpy and threads, as in ``tpubody``; the image resize
is the port's ``image.ops.scale_and_crop`` (bilinear, half-pixel centres,
within float32 rounding of ``tpubody``'s cv2 path).
"""
from __future__ import annotations

import queue
import threading
from typing import (Any, Callable, Iterator, List, NamedTuple, Optional,
                    Sequence)

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.image import ops as img_ops
from tpubody_torch.models.hmr_train import TrainBatch

# Left/right joint swap for the 24 SMPL joints under horizontal flip.
SMPL24_FLIP_PERM = np.array(
    [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15,
     17, 16, 19, 18, 21, 20, 23, 22], np.int64)


class HMRExample(NamedTuple):
    """One training example in the ORIGINAL image frame."""

    image: np.ndarray          # (H, W, 3) uint8 or float RGB
    keypoints2d: np.ndarray    # (K, 3) x, y, conf (pixels)
    gt_rotmats: Optional[np.ndarray] = None   # (24, 3, 3)
    gt_shape: Optional[np.ndarray] = None     # (10,)


class ArrayDataset:
    """In-memory dataset of :class:`HMRExample`; the minimal source for the
    loader (disk-backed sources only need ``__len__``/``__getitem__``)."""

    def __init__(self, examples: Sequence[HMRExample]):
        self._examples = list(examples)

    def __len__(self) -> int:
        return len(self._examples)

    def __getitem__(self, i: int) -> HMRExample:
        return self._examples[i]


def preprocess_example(ex: HMRExample, size: int = 224,
                       margin: float = 1.2) -> HMRExample:
    """Crop around the keypoint bbox and map keypoints to the crop frame."""
    center, scale = img_ops.crop_from_keypoints(ex.keypoints2d, margin)
    img = img_ops.scale_and_crop(ex.image, center, scale, size)
    img = img_ops.normalize_for_hmr(img)

    half = scale * 200.0 / 2.0
    kp = np.array(ex.keypoints2d, np.float32)
    x0 = round(float(center[0]) - half)
    y0 = round(float(center[1]) - half)
    ratio = size / (2.0 * half)
    kp[:, 0] = (kp[:, 0] - x0) * ratio
    kp[:, 1] = (kp[:, 1] - y0) * ratio
    return HMRExample(img.astype(np.float32), kp, ex.gt_rotmats, ex.gt_shape)


def random_flip(ex: HMRExample, rng: np.random.Generator,
                p: float = 0.5,
                perm: np.ndarray = SMPL24_FLIP_PERM) -> HMRExample:
    """Horizontal flip (after preprocessing, in the crop frame):

    image mirrors; keypoints mirror in x and swap left<->right (``perm``);
    rotation targets conjugate by diag(-1,1,1) and swap: a mirrored
    rotation is R' = M R M (M reverses the x axis; det(M R M)=+1)."""
    if rng.uniform() >= p:
        return ex
    W = ex.image.shape[1]
    img = ex.image[:, ::-1].copy()
    kp = np.array(ex.keypoints2d, np.float32)
    if len(kp) == len(perm):
        kp = kp[perm]
    kp[:, 0] = (W - 1) - kp[:, 0]
    rot = ex.gt_rotmats
    if rot is not None:
        M = np.diag([-1.0, 1.0, 1.0]).astype(rot.dtype)
        rot = (M @ rot[perm] @ M)
    return HMRExample(img, kp, rot, ex.gt_shape)


def jitter_scale(ex: HMRExample, rng: np.random.Generator,
                 lo: float = 0.9, hi: float = 1.1) -> HMRExample:
    """Brightness-preserving scale jitter around the crop center."""
    s = float(rng.uniform(lo, hi))
    H, W = ex.image.shape[:2]
    img = np.asarray(img_ops.scale_and_crop(
        ex.image, (W / 2.0, H / 2.0), (H / 200.0) / s, H), np.float32)
    kp = np.array(ex.keypoints2d, np.float32)
    kp[:, 0] = (kp[:, 0] - W / 2.0) * s + W / 2.0
    kp[:, 1] = (kp[:, 1] - H / 2.0) * s + H / 2.0
    return HMRExample(img, kp, ex.gt_rotmats, ex.gt_shape)


def collate(examples: Sequence[HMRExample]) -> TrainBatch:
    """Stack examples into one TrainBatch of float32 CPU tensors (missing
    GT -> identity rotations and zero shape with has_smpl=0, matching
    hmr_train.loss_fn masking)."""
    images = np.stack([e.image for e in examples]).astype(np.float32)
    kps = np.stack([e.keypoints2d for e in examples]).astype(np.float32)
    has = np.array([e.gt_rotmats is not None for e in examples], np.float32)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (24, 3, 3))
    rots = np.stack([e.gt_rotmats if e.gt_rotmats is not None else eye
                     for e in examples]).astype(np.float32)
    shapes = np.stack([e.gt_shape if e.gt_shape is not None
                       else np.zeros(10, np.float32)
                       for e in examples]).astype(np.float32)
    return TrainBatch(*[torch.from_numpy(a)
                        for a in (images, kps, has, rots, shapes)])


class DeviceLoader:
    """Iterate device-resident batches with background host prep + transfer.

    A worker thread draws indices (shuffled per epoch), applies
    ``transforms``, collates, and on CUDA pins each batch and copies it
    with ``non_blocking=True`` on a side stream, recording an event.  The
    consumer's stream waits on that event before the batch is handed out,
    and each tensor is marked as used on the consumer's stream
    (``record_stream``), so the caching allocator does not reuse its memory
    while work queued there still reads it.  Up to ``prefetch`` batches
    sit ready in a bounded queue: host work for batch N+1 overlaps device
    work for batch N.  ``device`` defaults to the card; a batch is never
    left on the host in its place.  ``sharding``
    (``dist.mesh.frames_sharding(mesh)``, in place of ``device``): each
    batch arrives already split into per-device shards, a TrainBatch of
    ``dist.mesh.Sharded`` (the batch size must divide by the mesh size).
    """

    _DONE = object()

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        transforms: Sequence[Callable[..., HMRExample]] = (),
        sharding: Optional[Any] = None,
        prefetch: int = 2,
        num_epochs: Optional[int] = 1,
        device: DeviceLike = "cuda",
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if sharding is not None:
            from tpubody_torch.dist import mesh as mesh_lib

            if not isinstance(sharding, mesh_lib.FramesSharding):
                raise TypeError("sharding must be dist.mesh.frames_sharding"
                                f"(mesh), not {type(sharding).__name__}")
            if batch_size % sharding.mesh.size:
                raise ValueError(
                    f"batch_size={batch_size} not divisible by mesh size "
                    f"{sharding.mesh.size}")
        if drop_last and len(dataset) < batch_size:
            # Every epoch would yield zero batches; with num_epochs=None the
            # worker would spin forever while the consumer blocks on an
            # empty queue (e.g. train-hmr --synthetic 8 with --batch 32).
            raise ValueError(
                f"dataset has {len(dataset)} examples < batch_size="
                f"{batch_size} with drop_last=True: no batch can ever be "
                "formed (shrink batch_size or pass drop_last=False)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.transforms = list(transforms)
        self.prefetch = max(1, prefetch)
        self.num_epochs = num_epochs
        self.sharding = sharding
        self.device = (sharding.mesh.devices[0] if sharding is not None
                       else resolve(device))

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _host_batches(self) -> Iterator[TrainBatch]:
        rng = np.random.default_rng(self.seed)
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                if len(idx) < self.batch_size and self.drop_last:
                    continue
                exs: List[HMRExample] = []
                for i in idx:
                    ex = self.dataset[int(i)]
                    for t in self.transforms:
                        ex = t(ex, rng)
                    exs.append(ex)
                yield collate(exs)
            epoch += 1

    def __iter__(self) -> Iterator[TrainBatch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err: List[BaseException] = []
        stop = threading.Event()
        if self.sharding is None:
            devices = [self.device]
        else:
            from tpubody_torch.dist import mesh as mesh_lib

            devices = list(self.sharding.mesh.devices)
        sides = {d: torch.cuda.Stream(d) for d in devices
                 if d.type == "cuda"}

        def put(host: TrainBatch, device):
            """-> (batch on ``device``, its copy's event or None)."""
            if device.type != "cuda":
                return host.to(device), None
            pinned = TrainBatch(*[x.pin_memory() for x in host])
            with torch.cuda.stream(sides[device]):
                dev = pinned.to(device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(sides[device])
            return dev, ready

        def to_device(host_batch: TrainBatch):
            """-> (batch, [(tensors, device, event or None)] to wait on)."""
            if self.sharding is None:
                dev, ready = put(host_batch, self.device)
                return dev, [(dev, self.device, ready)]
            pieces = [mesh_lib.split_frames(x, len(devices))
                      for x in host_batch]
            shards = [put(TrainBatch(*[p[i] for p in pieces]), d)
                      for i, d in enumerate(devices)]
            batch = TrainBatch(*[
                mesh_lib.Sharded([s[0][f] for s in shards],
                                 self.sharding.mesh)
                for f in range(len(host_batch))])
            return batch, [(s[0], d, s[1]) for s, d in zip(shards, devices)]

        def work():
            try:
                for host_batch in self._host_batches():
                    item = to_device(host_batch)
                    # Interruptible put: re-check the stop signal so an
                    # abandoned iterator (consumer took a few batches and
                    # walked away, e.g. a step-bounded training CLI) tears
                    # the worker down instead of blocking on q.put forever
                    # and pinning `prefetch` device-resident batches.
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                # Deliver the sentinel without ever displacing a real
                # batch: block (with stop re-checks) until the consumer
                # drains a slot.  An abandoned iterator sets `stop`, in
                # which case no sentinel is needed.
                while not stop.is_set():
                    try:
                        q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                batch, copies = item
                for tensors, device, ready in copies:
                    if ready is not None:
                        stream = torch.cuda.current_stream(device)
                        stream.wait_event(ready)
                        for x in tensors:
                            x.record_stream(stream)
                yield batch
            t.join()
            if err:
                raise err[0]
        finally:
            # GeneratorExit / close() path: signal the worker and drain the
            # queue so its pending put unblocks, freeing device buffers.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


def rendered_hmr_dataset(n: int = 16, image_size: int = 64, seed: int = 0,
                         n_verts: int = 1200, gen_batch: int = 8,
                         device: DeviceLike = "cuda") -> ArrayDataset:
    """Renderer-supervised HMR dataset: the capsule humanoid posed and
    rendered with full domain randomization (pipelines.pose_train
    synthesizer) on ``device``, with TRUE rotation-matrix / shape /
    2D-keypoint labels.  The draws come from a CPU ``torch.Generator``
    seeded with ``seed``, so a seed gives the same data on every device
    (up to the renderer's float32 rounding)."""
    from tpubody_torch.core.rotations import rodrigues
    from tpubody_torch.models import humanoid as humanoid_lib
    from tpubody_torch.pipelines import pose_train

    dev = resolve(device)
    body = humanoid_lib.humanoid(n_joints=24, n_verts=n_verts, seed=0,
                                 device=dev)
    synth = pose_train.make_synthesizer(body, size=image_size,
                                        domain_rand=True)
    gen = torch.Generator(device="cpu").manual_seed(seed)

    out: List[HMRExample] = []
    while len(out) < n:
        b = synth(gen, gen_batch)
        rots = rodrigues(b.poses.reshape(-1, 3)).reshape(-1, 24, 3, 3)
        # The domain-rand world rotation composes into the global orient
        # (it rotates about the body center, not joint 0 — the offset is
        # a translation, absorbed by the camera).
        rots[:, 0] = b.global_R @ rots[:, 0]
        imgs = torch.clamp(b.images * 255.0, 0, 255).to(torch.uint8)
        imgs, kps, rots = (imgs.cpu().numpy(),
                           b.keypoints.float().cpu().numpy(),
                           rots.float().cpu().numpy())
        betas = b.betas.float().cpu().numpy()
        for i in range(gen_batch):
            out.append(HMRExample(imgs[i], kps[i], rots[i], betas))
    return ArrayDataset(out[:n])


def synthetic_hmr_dataset(n: int = 16, image_size: int = 64,
                          seed: int = 0) -> ArrayDataset:
    """Deterministic random dataset for tests and input-pipeline benches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 255, (image_size, image_size, 3),
                           dtype=np.uint8)
        kp = np.concatenate([
            rng.uniform(4, image_size - 4, (24, 2)),
            np.ones((24, 1))], axis=1).astype(np.float32)
        rots = np.broadcast_to(np.eye(3, dtype=np.float32),
                               (24, 3, 3)).copy()
        out.append(HMRExample(img, kp, rots, np.zeros(10, np.float32)))
    return ArrayDataset(out)
