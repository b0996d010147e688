"""tpubody_torch.dist.mesh and the entry points that take a mesh, against
tpubody.dist.mesh on the root conftest's 8 virtual JAX CPU devices and
against the port's own unsharded results.

The port's CPU mesh lists the CPU 8 times (the counterpart of XLA's
forced host device count); a sharded call is one pass per shard, then a
concatenation.  Bars: LBS within 1e-5 of both the unsharded port and
tpubody's sharded program (float32 sums in another order); the mean
within 1e-5; served outputs equal to the same step on the shard's rows
(the same computation); the fit per lane within the whole-fit bars of
tests/test_torch_fit_frames.py (loss rtol 1e-3; pose, betas, camera 1e-3)
against the unsharded fit; frames of animate_video(mesh=) equal to the
unsharded ones (the same renderer on the same frames).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_fit_common as fit_common
from tpubody.dist import mesh as jmesh
from tpubody.models import params as jparams
from tpubody.models import smpl as jsmpl
from tpubody_torch.dist import mesh as tmesh
from tpubody_torch.models import params as tparams
from tpubody_torch.models import smpl as tsmpl

torch.set_num_threads(1)

LBS_ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return jmesh.make_mesh(8)


def test_make_mesh(mesh8, monkeypatch):
    assert mesh8.shape == {"frames": 8} and mesh8.size == 8
    assert mesh8.distinct() == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = tmesh.make_mesh()
    assert two.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="2 CUDA devices"):
        tmesh.make_mesh(3)


def test_make_mesh_needs_cuda_or_a_device_list():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="devices="):
        tmesh.make_mesh()


@pytest.mark.parametrize("n", [10, 16, 1])
def test_pad_frames_matches_tpubody(n):
    x = np.arange(n)[:, None] * np.ones((n, 3))
    want = np.asarray(jmesh.pad_frames(jnp.asarray(x), 8))
    np.testing.assert_array_equal(tmesh.pad_frames(x, 8), want)
    np.testing.assert_array_equal(
        tmesh.pad_frames(torch.as_tensor(x), 8).numpy(), want)


def test_shard_frames_distributes(mesh8):
    x = torch.arange(64.0).reshape(16, 4)
    tree = tmesh.shard_frames({"x": x, "y": [x.numpy()]}, mesh8)
    sx = tree["x"]
    assert isinstance(sx, tmesh.Sharded) and sx.shape == (16, 4)
    assert len(sx.shards) == 8 and all(s.shape == (2, 4) for s in sx.shards)
    torch.testing.assert_close(sx.gather(), x, atol=0, rtol=0)
    torch.testing.assert_close(tree["y"][0].gather(), x, atol=0, rtol=0)
    with pytest.raises(ValueError, match="pad_frames"):
        tmesh.shard_frames(torch.zeros(10, 4), mesh8)


def test_replicate_copies_once_a_device():
    model = torch.nn.Linear(3, 2)
    mesh = tmesh.make_mesh(devices=["cpu", "cpu", "cpu"])
    copies = tmesh.replicate({"m": model, "t": torch.ones(2)}, mesh)
    assert len(copies) == 3
    assert copies[0]["m"] is copies[2]["m"] and copies[0]["m"] is not model
    torch.testing.assert_close(copies[1]["m"].weight, model.weight)

    def fn(x):
        return x
    assert tmesh.replicate(fn, mesh) == [fn] * 3


def _sharded_verts(model, poses, beta, mesh):
    """forward_batch per shard on its device's replica -> gathered."""
    models = tmesh.replicate(model, mesh)
    sharded = tmesh.shard_frames(poses, mesh)
    outs = []
    for m, d, p in zip(models, mesh.devices, sharded.shards):
        with tmesh.on_device(d):
            outs.append(tsmpl.forward_batch(m, p, beta.to(d), None).verts)
    return torch.cat(outs)


def test_sharded_lbs_matches_single_device_and_tpubody(mesh8, jmesh8):
    jmodel = jparams.synthetic(n_joints=24, n_verts=200, seed=3)
    tmodel = tparams.synthetic(n_joints=24, n_verts=200, seed=3,
                               device="cpu")
    rng = np.random.default_rng(0)
    poses = rng.normal(scale=0.2, size=(16, 24, 3)).astype(np.float32)
    beta = rng.normal(size=(10,)).astype(np.float32)

    data_sh = jmesh.frames_sharding(jmesh8)
    rep_sh = jmesh.replicated(jmesh8)
    fn = jax.jit(lambda m, p, b: jsmpl.forward_batch(m, p, b, None).verts,
                 in_shardings=(rep_sh, data_sh, rep_sh),
                 out_shardings=data_sh)
    want = np.asarray(fn(jmesh.replicate(jmodel, jmesh8),
                         jax.device_put(jnp.asarray(poses), data_sh),
                         jax.device_put(jnp.asarray(beta), rep_sh)))

    tp, tb = torch.as_tensor(poses), torch.as_tensor(beta)
    got = _sharded_verts(tmodel, tp, tb, mesh8)
    ref = tsmpl.forward_batch(tmodel, tp, tb, None).verts
    assert np.abs(got.numpy() - ref.numpy()).max() < LBS_ATOL
    assert np.abs(got.numpy() - want).max() < LBS_ATOL


def test_sharded_mean_matches(mesh8, jmesh8):
    """A mean over frames sharded 8 ways: per-shard sums, combined;
    tpubody's sharded program and the unsharded mean agree."""
    jmodel = jparams.synthetic(n_joints=24, n_verts=150, seed=4)
    tmodel = tparams.synthetic(n_joints=24, n_verts=150, seed=4,
                               device="cpu")
    poses = np.random.default_rng(1).normal(
        scale=0.2, size=(8, 24, 3)).astype(np.float32)
    data_sh = jmesh.frames_sharding(jmesh8)
    fn = jax.jit(lambda p: jnp.mean(jsmpl.forward_batch(
        jmodel, p, jnp.zeros(10), None).verts),
        in_shardings=(data_sh,), out_shardings=jmesh.replicated(jmesh8))
    want = float(fn(jax.device_put(jnp.asarray(poses), data_sh)))

    sharded = tmesh.shard_frames(torch.as_tensor(poses), mesh8)
    total = sum(tsmpl.forward_batch(tmodel, p, torch.zeros(10), None)
                .verts.double().sum() for p in sharded.shards)
    got = float(total) / (8 * 150 * 3)
    ref = float(tsmpl.forward_batch(tmodel, torch.as_tensor(poses),
                                    torch.zeros(10), None).verts.mean())
    assert abs(got - ref) < 1e-5 and abs(got - want) < 1e-5


class ShardStep:
    """x * 2 + 1 and each row's shard size; replicated by ``to``."""

    def __init__(self, device="cpu", calls=None):
        self.device = torch.device(device)
        self.calls = [] if calls is None else calls

    def to(self, device):
        return ShardStep(device, self.calls)

    def __call__(self, x):
        self.calls.append(x.shape[0])
        return x * 2.0 + 1.0, torch.full((x.shape[0],), float(x.shape[0]))


def test_inference_server_shards_each_batch(mesh8):
    from tpubody_torch.pipelines import serving

    step = ShardStep()
    sharding = tmesh.frames_sharding(mesh8)
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        serving.InferenceServer(step, image_shape=(3,), buckets=(4, 8),
                                sharding=sharding, warmup=False)
    server = serving.InferenceServer(step, image_shape=(3,), buckets=(8, 16),
                                     sharding=sharding)
    assert step.calls == [1] * 8 + [2] * 8           # warm-up, per shard
    xs = np.random.default_rng(0).normal(size=(11, 3)).astype(np.float32)
    with server:
        futures = [server.submit(x) for x in xs]
        results = [f.result(timeout=60) for f in futures]
    for x, (y, rows) in zip(xs, results):
        np.testing.assert_array_equal(y, x * 2.0 + 1.0)
        assert rows in (1.0, 2.0)
    assert server.stats.snapshot()["requests"] == 11


def test_inference_server_sharded_hmr_step(mesh8):
    """The f32 serving step behind a sharded server equals the step on
    the same rows (one shard's rows through the same model)."""
    from tpubody_torch.pipelines import serving

    step = serving.hmr_smpl_step(dtype=torch.float32, image_size=32,
                                 n_verts=300, device="cpu")
    server = serving.InferenceServer(
        step, step.image_shape, buckets=(8,), to_host=False,
        sharding=tmesh.frames_sharding(mesh8))
    images = np.random.default_rng(2).normal(
        size=(8, 32, 32, 3)).astype(np.float32)
    with server:
        results = [f.result(timeout=120) for f in
                   [server.submit(im) for im in images]]
    for im, (verts, cam) in zip(images, results):
        v1, c1 = step(im[None])
        assert verts.shape == (300, 3)
        torch.testing.assert_close(verts, v1[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(cam, c1[0], atol=1e-5, rtol=0)


def test_device_loader_shards_each_batch():
    from tests.test_torch_dataset import _data
    from tpubody_torch.io import dataset as tds

    data = _data(8)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh size 4"):
        tds.DeviceLoader(data, batch_size=6,
                         sharding=tmesh.frames_sharding(mesh))
    plain = list(tds.DeviceLoader(data, batch_size=4, seed=3, device="cpu"))
    sharded = list(tds.DeviceLoader(data, batch_size=4, seed=3,
                                    sharding=tmesh.frames_sharding(mesh)))
    assert len(sharded) == len(plain) == 2
    for a, b in zip(plain, sharded):
        for x, s in zip(a, b):
            assert isinstance(s, tmesh.Sharded) and len(s.shards) == 4
            assert all(p.shape[0] == 1 for p in s.shards)
            torch.testing.assert_close(s.gather(), x, atol=0, rtol=0)


def test_fit_frames_over_a_mesh_matches_unsharded():
    from tpubody_torch.fit import smplify as ts

    jm, tm = fit_common.models()
    tree = fit_common.decoder_tree()
    kps = fit_common.keypoints(jm, tree)
    cfg = ts.FitConfig(focal_length=fit_common.FOCAL, maxiters=2,
                       side_view_thsh=24.5)
    fitter = ts.BatchFitter(tm, cfg, dec_params=tree, device="cpu")
    whole = fitter(kps, fit_common.CENTER)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)     # 3 -> bucket 4 -> 4 x 1
    sharded = ts.fit_frames(tm, kps, fit_common.CENTER, cfg,
                            dec_params=tree, mesh=mesh, device="cpu")
    assert sharded.pose.shape == (3, 156)
    fit_common.hold_fits(whole, sharded)
    direct = fitter.apply(torch.as_tensor(kps),
                          torch.as_tensor(np.tile(fit_common.CENTER, (3, 1))),
                          mesh=mesh)
    np.testing.assert_allclose(direct["loss"].numpy(), sharded.loss,
                               rtol=1e-6)


def test_gen_smplh_batch_shard_flag(tmp_path, monkeypatch):
    """``gen-smplh-batch --shard`` passes a mesh over every CUDA device
    when there are several, as tpubody's CLI does."""
    from tpubody_torch import cli
    from tpubody_torch.pipelines import gen_smplh

    dirs = []
    for name in ("a", "b"):
        d = tmp_path / name
        d.mkdir()
        (d / "front_rgb.png").write_bytes(b"")
        (d / "0_keypoints.json").write_text("{}")
        dirs.append(str(d))
    calls = []
    monkeypatch.setattr(gen_smplh, "gen_smplh_batch",
                        lambda items, **k: calls.append(k))
    assert cli.main(["--device", "cpu", "gen-smplh-batch", "--shard"]
                    + dirs) == 0
    assert calls[-1]["mesh"] is None              # the CPU: no mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.main(["gen-smplh-batch", "--shard"] + dirs) == 0
    assert calls[-1]["mesh"].size == 2
    assert cli.main(["gen-smplh-batch"] + dirs) == 0
    assert calls[-1]["mesh"] is None


@pytest.mark.parametrize("size", [64, 128])
def test_animate_video_over_mesh_matches_unsharded(tmp_path, size):
    """5 frames over 4 shards (padded to 8) in blocks of 2: the fragment
    renderer at 64^2, the tiled one at 128^2."""
    from tests.torch_multihost_worker import record_writer
    from tests.test_torch_rigging import both_avatars
    from tpubody_torch.io import motion as tmotion
    from tpubody_torch.pipelines import animate as tanimate
    from tpubody_torch.render import video as tvideo

    _, tav = both_avatars()
    rng = np.random.default_rng(4)
    clip = tmotion.MotionClip(rng.normal(scale=0.05, size=(5, 24, 3)),
                              rng.normal(scale=0.02, size=(5, 3)), 30.0)
    kw = dict(size=size, focal=150.0 * size / 64, cam_t=np.array(
        [0.0, 0.0, 3.0]), chunk=2, crop_transfer=False, i420_transfer=False,
        device="cpu")
    write = tvideo.VideoWriter.write
    frames = {}
    try:
        for name, mesh in (("plain", None), ("mesh", tmesh.make_mesh(
                devices=["cpu"] * 4))):
            frames[name] = []
            record_writer(frames[name])
            tanimate.animate_video(tav, clip, str(tmp_path / f"{name}.mp4"),
                                   mesh=mesh, **kw)
            tvideo.VideoWriter.write = write
    finally:
        tvideo.VideoWriter.write = write
    assert len(frames["mesh"]) == len(frames["plain"]) == 5
    np.testing.assert_array_equal(np.stack(frames["mesh"]),
                                  np.stack(frames["plain"]))
    assert (np.stack(frames["mesh"]) < 255).any(axis=-1).mean() > 0.02
