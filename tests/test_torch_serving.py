"""tpubody_torch.pipelines: the whole slice against tpubody, the
InferenceServer behaviours of tests/test_serving.py, and import hygiene.

The slice test runs hmr_smpl_step(device="cpu", fp32, 64^2, 300 verts)
and the JAX composition (Flax HMR apply + smpl.forward_batch_verts with
use_pallas=False) on the same weights (the port's, converted by tpubody's
convert_torch_state_dict) and images: verts within 1e-4 (the repo's
vertex budget), camera within 1e-4.
"""
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tpubody_torch.models import params as tparams
from tpubody_torch.pipelines import hmr_infer
from tpubody_torch.pipelines import serving

torch.set_num_threads(1)

SHAPE = (8, 8, 3)


def test_slice_matches_tpubody():
    import jax.numpy as jnp

    from tpubody.models import hmr as jhmr
    from tpubody.models import params as jparams
    from tpubody.models import smpl as jsmpl

    step = serving.hmr_smpl_step(device="cpu", dtype=torch.float32,
                                 image_size=64, n_verts=300)
    reference = {k[len("backbone."):] if k.startswith("backbone.") else k:
                 v.numpy() for k, v in step.hmr.state_dict().items()
                 if not k.endswith("num_batches_tracked")}
    variables = jhmr.convert_torch_state_dict(reference,
                                              jhmr.default_mean_params())
    model = jhmr.HMR(mean_params=jhmr.default_mean_params(),
                     dtype=jnp.float32)
    body = jparams.load_or_synthetic("smpl", n_joints=24, n_verts=300,
                                     seed=0, warn=False)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)

    out = model.apply(variables, jnp.asarray(images))
    want_v = np.asarray(jsmpl.forward_batch_verts(
        body, out.rotmats, out.shape, None, use_pallas=False,
        pose_is_rotmat=True))
    verts, cam = step(images)
    assert verts.shape == (3, 300, 3) and cam.shape == (3, 3)
    assert np.abs(verts.numpy() - want_v).max() < 1e-4
    assert np.abs(cam.numpy() - np.asarray(out.cam)).max() < 1e-4


def test_hmr_predictor_composition():
    """HMRPredictor = HMR -> forward_batch -> weak-perspective camera."""
    from tpubody.render import camera as jcam
    from tpubody_torch.models import smpl as tsmpl

    body = tparams.synthetic(n_joints=24, n_verts=120, seed=1, device="cpu")
    pred = hmr_infer.HMRPredictor(smpl_model=body, dtype=torch.float32,
                                  img_size=64, device="cpu")
    images = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    res = pred(images)
    assert res.verts.shape == (2, 120, 3) and res.rotmats.shape == (2, 24, 3, 3)
    with torch.no_grad():
        out = pred.model(torch.as_tensor(images))
        verts = tsmpl.forward_batch(body, out.rotmats, out.shape,
                                    pose_is_rotmat=True).verts
    torch.testing.assert_close(res.verts, verts)
    want_t = np.asarray(jcam.weak_perspective_translation(
        np.asarray(res.cam), 5000.0, 64))
    np.testing.assert_allclose(res.cam_t.numpy(), want_t, rtol=1e-6)


def test_predictor_loads_reference_checkpoint(tmp_path):
    body = tparams.synthetic(n_joints=24, n_verts=50, seed=1, device="cpu")
    src = hmr_infer.HMRPredictor(smpl_model=body, dtype=torch.float32,
                                 device="cpu")
    reference = {k[len("backbone."):] if k.startswith("backbone.") else k: v
                 for k, v in src.model.state_dict().items()}
    path = str(tmp_path / "hmr.pt")
    torch.save({"model": reference}, path)
    dst = hmr_infer.HMRPredictor(smpl_model=body, dtype=torch.float32,
                                 device="cpu", state_dict=None)
    with torch.no_grad():
        for p in dst.model.parameters():
            p.zero_()
    dst.load_torch_checkpoint(path)
    for (k, a), b in zip(src.model.state_dict().items(),
                         dst.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_unported_paths_raise():
    with pytest.raises(TypeError, match="frames_sharding"):
        serving.InferenceServer(double_step, image_shape=SHAPE, buckets=(1,),
                                sharding=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serving.hmr_smpl_step()       # the card is the default
        with pytest.raises(RuntimeError, match="cuda"):
            serving.fit_smplh_step()      # ported: the card is its default
        with pytest.raises(RuntimeError, match="cuda"):
            serving.InferenceServer(double_step, warmup=False)


def test_import_hygiene():
    """No module of tpubody_torch imports jax, flax or tpubody."""
    code = r"""
import importlib, pkgutil, sys
import tpubody_torch
names = [m.name for m in pkgutil.walk_packages(tpubody_torch.__path__,
                                                "tpubody_torch.")]
for n in names:
    importlib.import_module(n)
import tpubody_torch.bench
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpubody"))
assert len(names) >= 15, names
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


# -- InferenceServer (the behaviours tests/test_serving.py pins) -----------
def double_step(images):
    return images * 2.0, torch.sum(images, dim=(1, 2, 3))


@pytest.fixture()
def server():
    s = serving.InferenceServer(double_step, image_shape=SHAPE,
                                buckets=(1, 2, 4), max_delay_ms=10.0,
                                device="cpu")
    with s:
        yield s


class TestServer:
    def test_single_request_roundtrip(self, server):
        img = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
        doubled, total = server(img)
        np.testing.assert_allclose(doubled, img * 2.0, rtol=1e-6)
        np.testing.assert_allclose(total, img.sum(), rtol=1e-4)

    def test_concurrent_requests_map_to_own_results(self, server):
        rng = np.random.default_rng(1)
        imgs = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(9)]
        futures = [server.submit(im) for im in imgs]
        for im, f in zip(imgs, futures):
            doubled, _ = f.result(timeout=30)
            np.testing.assert_allclose(doubled, im * 2.0, rtol=1e-6)
        snap = server.stats.snapshot()
        assert snap["requests"] == 9
        assert snap["batches"] >= 3      # bucket cap is 4
        assert snap["latency_p50_ms"] > 0

    def test_coalescing_under_parallel_load(self, server):
        rng = np.random.default_rng(2)
        imgs = [rng.normal(size=SHAPE).astype(np.float32)
                for _ in range(16)]
        results = [None] * 16

        def send(i):
            results[i] = server(imgs[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i in range(16):
            np.testing.assert_allclose(results[i][0], imgs[i] * 2.0,
                                       rtol=1e-6)
        snap = server.stats.snapshot()
        assert snap["batches"] < snap["requests"]

    def test_shape_validation(self, server):
        with pytest.raises(ValueError):
            server.submit(np.zeros((4, 4, 3), np.float32))

    def test_stop_fails_pending_futures(self):
        s = serving.InferenceServer(double_step, image_shape=SHAPE,
                                    buckets=(1, 2, 4), max_delay_ms=10.0,
                                    device="cpu")
        f = s.submit(np.zeros(SHAPE, np.float32))   # never started
        s.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=5)

    def test_submit_after_stop_raises(self):
        s = serving.InferenceServer(double_step, image_shape=SHAPE,
                                    buckets=(1, 2), max_delay_ms=1.0,
                                    device="cpu").start()
        s(np.zeros(SHAPE, np.float32))
        s.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            s.submit(np.zeros(SHAPE, np.float32))

    def test_step_error_propagates(self):
        def bad_step(images):
            raise RuntimeError("kernel boom")

        s = serving.InferenceServer(bad_step, image_shape=SHAPE,
                                    buckets=(1,), warmup=False, device="cpu")
        with s:
            f = s.submit(np.zeros(SHAPE, np.float32))
            with pytest.raises(RuntimeError, match="kernel boom"):
                f.result(timeout=30)
            # The loop keeps serving after a failed batch.
            assert s.submit(np.zeros(SHAPE, np.float32)).exception(
                timeout=30) is not None


def test_device_resident_results():
    s = serving.InferenceServer(double_step, image_shape=SHAPE,
                                buckets=(1, 2), max_delay_ms=5.0,
                                to_host=False, device="cpu")
    img = np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
    with s:
        doubled, total = s(img)
    assert isinstance(doubled, torch.Tensor)
    np.testing.assert_allclose(doubled.numpy(), img * 2.0, rtol=1e-6)


def test_backlogged_requests_coalesce_not_batch1():
    s = serving.InferenceServer(double_step, image_shape=SHAPE,
                                buckets=(1, 2, 8), max_delay_ms=1.0,
                                device="cpu")
    rng = np.random.default_rng(3)
    imgs = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(16)]
    futures = [s.submit(im) for im in imgs]      # backlog before start
    with s:
        for im, f in zip(imgs, futures):
            doubled, _ = f.result(timeout=30)
            np.testing.assert_allclose(doubled, im * 2.0, rtol=1e-6)
    assert s.stats.snapshot()["batches"] <= 4


def test_only_bucket_shapes_reach_the_step():
    shapes = []

    def counting_step(images):
        shapes.append(images.shape[0])
        return images * 2.0, torch.sum(images, dim=(1, 2, 3))

    s = serving.InferenceServer(counting_step, image_shape=SHAPE,
                                buckets=(1, 2, 4), max_delay_ms=5.0,
                                device="cpu")
    rng = np.random.default_rng(7)
    with s:
        for wave in (1, 3, 4, 2, 5):
            imgs = [rng.normal(size=SHAPE).astype(np.float32)
                    for _ in range(wave)]
            futs = [s.submit(im) for im in imgs]
            for im, f in zip(imgs, futs):
                np.testing.assert_allclose(f.result(timeout=60)[0], im * 2.0,
                                           rtol=1e-6)
    assert set(shapes) <= {1, 2, 4}, shapes


class TestTreeRequests:
    def test_dict_request_spec_roundtrip(self):
        spec = {"a": serving.TensorSpec((2,), np.float32),
                "b": serving.TensorSpec((3,), np.float32)}

        def step(req):
            return {"sum": req["a"].sum(dim=1) + req["b"].sum(dim=1),
                    "a2": req["a"] * 2.0}

        s = serving.InferenceServer(step, buckets=(1, 2), max_delay_ms=5.0,
                                    request_spec=spec, device="cpu")
        rng = np.random.default_rng(0)
        reqs = [{"a": rng.normal(size=(2,)).astype(np.float32),
                 "b": rng.normal(size=(3,)).astype(np.float32)}
                for _ in range(3)]
        with s:
            futs = [s.submit(r) for r in reqs]
            for r, f in zip(reqs, futs):
                out = f.result(timeout=30)
                np.testing.assert_allclose(
                    out["sum"], r["a"].sum() + r["b"].sum(), rtol=1e-5)
                np.testing.assert_allclose(out["a2"], r["a"] * 2.0,
                                           rtol=1e-6)

    def test_structure_mismatch_rejected(self):
        spec = {"a": serving.TensorSpec((2,), np.float32)}
        s = serving.InferenceServer(lambda req: req["a"], buckets=(1,),
                                    request_spec=spec, warmup=False,
                                    device="cpu")
        with pytest.raises(ValueError, match="structure"):
            s.submit(np.zeros(2, np.float32))
        with pytest.raises(ValueError, match="leaf shape"):
            s.submit({"a": np.zeros(3, np.float32)})


def test_stats_snapshot_percentiles():
    st = serving.ServerStats()
    st.record(3, 1, [0.001, 0.002, 0.003])
    snap = st.snapshot()
    assert snap["requests"] == 3 and snap["padded_rows"] == 1
    assert snap["latency_p50_ms"] == pytest.approx(2.0)
    assert snap["latency_p99_ms"] == pytest.approx(3.0)
