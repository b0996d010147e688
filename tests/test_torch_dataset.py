"""tpubody_torch.io.dataset against tpubody.io.dataset on the CPU.

The host-side functions are numpy copies: keypoints, flips, collation and
the synthetic dataset are bit-identical; the preprocessed images go
through the port's bilinear resize, within 2e-2 of tpubody's cv2 path on
a 0..255 image (tests/test_torch_image_ops.py gives the reason), i.e.
within 2e-2 / (255 * 0.224) after ImageNet normalization.  The
DeviceLoader runs on the CPU here (no card): order, drop_last, the
batch-size error, prefetch, error propagation and the teardown of an
abandoned iterator."""
import threading
import time

import numpy as np
import pytest
import torch

from tpubody.io import dataset as jds
from tpubody_torch.core.rotations import rodrigues
from tpubody_torch.io import dataset as tds
from tpubody_torch.models import humanoid as thum
from tpubody_torch.pipelines import pose_train

torch.set_num_threads(1)

IMG_ATOL = 2e-2 / (255 * 0.224)


def _pair(n=4, image_size=48, seed=0):
    return (jds.synthetic_hmr_dataset(n, image_size=image_size, seed=seed),
            tds.synthetic_hmr_dataset(n, image_size=image_size, seed=seed))


def _same(a, b, atol=0.0):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        elif atol:
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       atol=atol)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_synthetic_dataset_equal():
    j, t = _pair(6)
    assert len(j) == len(t) == 6
    for a, b in zip(j._examples, t._examples):
        _same(a, b)


@pytest.mark.parametrize("size", [32, 64])
def test_preprocess_example(size):
    j, t = _pair(3, image_size=80, seed=1)
    for a, b in zip(j._examples, t._examples):
        pa = jds.preprocess_example(a, size=size)
        pb = tds.preprocess_example(b, size=size)
        np.testing.assert_array_equal(pb.keypoints2d, pa.keypoints2d)
        assert pb.image.dtype == np.float32
        np.testing.assert_allclose(pb.image, pa.image, atol=IMG_ATOL)
        _same(pa[2:], pb[2:])


def test_random_flip_and_jitter_with_the_same_generator():
    j, t = _pair(4, image_size=48, seed=2)
    for i, (a, b) in enumerate(zip(j._examples, t._examples)):
        rot = np.array(a.gt_rotmats)
        rot[1] = rodrigues(torch.tensor([[0.3, -0.7, 0.2]]))[0].numpy()
        a, b = a._replace(gt_rotmats=rot), b._replace(gt_rotmats=rot.copy())
        fa = jds.random_flip(a, np.random.default_rng(i))
        fb = tds.random_flip(b, np.random.default_rng(i))
        _same(fa, fb)
        ja = jds.jitter_scale(a, np.random.default_rng(10 + i))
        jb = tds.jitter_scale(b, np.random.default_rng(10 + i))
        np.testing.assert_array_equal(jb.keypoints2d, ja.keypoints2d)
        np.testing.assert_allclose(jb.image, ja.image, atol=2e-2)


def test_collate_equal_and_masks_missing_gt():
    j, t = _pair(4, image_size=32, seed=3)
    ja = list(j._examples)
    tb = list(t._examples)
    ja[2] = ja[2]._replace(gt_rotmats=None, gt_shape=None)
    tb[2] = tb[2]._replace(gt_rotmats=None, gt_shape=None)
    want, got = jds.collate(ja), tds.collate(tb)
    for w, g in zip(want, got):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.has_smpl.numpy(), [1, 1, 0, 1])


def _data(n, size=16, seed=7):
    return tds.ArrayDataset([
        tds.preprocess_example(e, size=size)
        for e in tds.synthetic_hmr_dataset(n, image_size=24, seed=seed)
        ._examples])


def test_loader_order_matches_tpubody():
    """Same seed, same shuffled order and flips as tpubody's loader."""
    def flip(mod):
        return lambda e, r: mod.random_flip(e, r)
    jdata = jds.ArrayDataset([
        jds.preprocess_example(e, size=16)
        for e in jds.synthetic_hmr_dataset(10, image_size=24, seed=7)
        ._examples])
    want = list(jds.DeviceLoader(jdata, batch_size=3, seed=5, num_epochs=2,
                                 transforms=[flip(jds)]))
    got = list(tds.DeviceLoader(_data(10), batch_size=3, seed=5,
                                num_epochs=2, transforms=[flip(tds)],
                                device="cpu"))
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.keypoints2d.numpy(),
                                      np.asarray(w.keypoints2d))
        np.testing.assert_array_equal(g.gt_rotmats.numpy(),
                                      np.asarray(w.gt_rotmats))


def test_loader_drop_last_len_and_batch_size_error():
    data = _data(10)
    loader = tds.DeviceLoader(data, batch_size=4, num_epochs=2,
                              device="cpu")
    assert len(loader) == 2 and sum(1 for _ in loader) == 4
    partial = tds.DeviceLoader(data, batch_size=4, drop_last=False,
                               device="cpu")
    assert len(partial) == 3
    assert [b.images.shape[0] for b in partial] == [4, 4, 2]
    with pytest.raises(ValueError, match="drop_last"):
        tds.DeviceLoader(data, batch_size=32, num_epochs=None, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tds.DeviceLoader(data, batch_size=0, device="cpu")
    with pytest.raises(TypeError, match="frames_sharding"):
        tds.DeviceLoader(data, batch_size=2, sharding=object(), device="cpu")


def test_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legal here")
    with pytest.raises(RuntimeError, match="cuda"):
        tds.DeviceLoader(_data(4), batch_size=2)


def test_loader_prefetch_never_drops_batches():
    data = _data(32)
    for trial in range(20):
        loader = tds.DeviceLoader(data, batch_size=16, seed=trial,
                                  prefetch=2, device="cpu")
        assert len(list(loader)) == 2, trial


def test_loader_worker_error_propagates():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(tds.DeviceLoader(Bad(), batch_size=2, device="cpu"))


def test_abandoned_iterator_stops_worker():
    loader = tds.DeviceLoader(tds.synthetic_hmr_dataset(32, image_size=8),
                              batch_size=2, num_epochs=None, prefetch=2,
                              device="cpu")
    before = threading.active_count()
    it = iter(loader)
    for _ in range(3):
        next(it)
    it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_rendered_dataset_labels_match_the_images():
    """The examples are the synthesizer's batch for the seed's draws; the
    world rotation is composed into joint 0; valid keypoints land on the
    rendered body (pixels that stay put when only the background
    changes), up to one pixel: at 48^2 a joint near a thin limb's edge
    may fall on the pixel beside it."""
    size = 48
    data = tds.rendered_hmr_dataset(4, image_size=size, seed=0,
                                    gen_batch=4, device="cpu")
    assert len(data) == 4
    body = thum.humanoid(n_joints=24, n_verts=1200, seed=0)
    synth = pose_train.make_synthesizer(body, size=size, domain_rand=True)
    d = synth.draw(torch.Generator().manual_seed(0), 4)
    b = synth.render(d)
    b2 = synth.render(d._replace(coarse=1.0 - d.coarse))
    body_px = (b.images - b2.images).abs().amax(-1) < 1e-6
    body_px = torch.nn.functional.max_pool2d(
        body_px[:, None].float(), 3, stride=1, padding=1)[:, 0] > 0
    rot = rodrigues(d.poses.reshape(-1, 3)).reshape(4, 24, 3, 3)
    on_body = []
    for i, ex in enumerate(data._examples):
        assert ex.image.dtype == np.uint8 and ex.image.shape == (size, size, 3)
        np.testing.assert_array_equal(
            ex.image, torch.clamp(b.images[i] * 255, 0, 255)
            .to(torch.uint8).numpy())
        np.testing.assert_allclose(ex.gt_rotmats[0],
                                   (d.R[i] @ rot[i, 0]).numpy(), atol=1e-6)
        np.testing.assert_allclose(ex.gt_rotmats[1:], rot[i, 1:].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(ex.gt_rotmats), 1.0,
                                   atol=1e-4)
        np.testing.assert_array_equal(ex.gt_shape, d.betas.numpy())
        kp = ex.keypoints2d[ex.keypoints2d[:, 2] > 0]
        assert len(kp) > 12
        assert (kp[:, :2] >= 0).all() and (kp[:, :2] < size).all()
        px = np.floor(kp[:, :2]).astype(int)
        on_body += body_px[i, px[:, 1], px[:, 0]].tolist()
    assert np.mean(on_body) > 0.97, np.mean(on_body)
