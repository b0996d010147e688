"""tpubody_torch.pipelines.pose_train against tpubody.pipelines.pose_train
on the CPU.  The synthesizer's draws are split from its render, so the
port renders ``tpubody``'s own draws: this file makes them with
``tpubody``'s split sequence of ``jax.random`` keys (a copy of the calls
in ``make_synthesizer``'s ``synth``) and feeds them to
``Synthesizer.render``.

Bars: keypoints 1e-4 px (the same float32 projection); images: both
packages' plain fragment rasterizers on the same float32 geometry, so a
pixel whose centre lies within rounding of a triangle edge may take the
neighbouring face: at most 1% of the pixels may differ by more than 1e-4
(measured: none at 48^2 with 300 vertices), the rest within 1e-4; the
cubic resize: max |d| <= 1e-6 against ``jax.image.resize``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.models import params as jparams
from tpubody.pipelines import pose_train as jtrain
from tpubody_torch.models import params as tparams
from tpubody_torch.pipelines import pose_train as ttrain

torch.set_num_threads(1)

KP_ATOL = 1e-4
IMG_ATOL = 1e-4
IMG_SHARE = 0.01


def jax_draws(synth_t, key, batch, body):
    """tpubody's draws for ``key`` (the calls of its synth, in order)."""
    size, n_occ = synth_t.size, synth_t.n_occluders
    (kp_key, c_key, rot_key, cam_key, bg_key, photo_key,
     occ_key, beta_key) = jax.random.split(key, 8)
    poses = 0.25 * jax.random.normal(kp_key, (batch, body.num_joints, 3))
    colors = 0.4 + 0.5 * jax.random.uniform(c_key, (body.num_verts, 3))
    if not synth_t.domain_rand:
        d = synth_t.draw(torch.Generator().manual_seed(0), batch)
        return d._replace(poses=torch.as_tensor(np.asarray(poses)),
                          colors=torch.as_tensor(np.asarray(colors)))
    betas = 0.5 * jax.random.normal(beta_key, (10,))
    R = jtrain._yaw_pitch_roll(rot_key, batch, 1.0, 0.15)
    kz, kxy = jax.random.split(cam_key)
    dz = jax.random.uniform(kz, (batch, 1), minval=-0.25, maxval=0.45)
    dxy = 0.07 * synth_t.extent * jax.random.normal(kxy, (batch, 2))
    coarse = jax.random.uniform(bg_key, (batch, 6, 6, 3))
    kb, kc, kg, _ = jax.random.split(photo_key, 4)
    bright = 0.15 * jax.random.normal(kb, (batch, 1, 1, 1))
    contr = 1.0 + 0.25 * jax.random.normal(kc, (batch, 1, 1, 1))
    gain = 1.0 + 0.12 * jax.random.normal(kg, (batch, 1, 1, 3))
    cxy, wh, col = [], [], []
    for i in range(n_occ):
        kc1, kc2, kc3, _ = jax.random.split(jax.random.fold_in(occ_key, i), 4)
        cxy.append(size * jax.random.uniform(kc1, (batch, 2)))
        wh.append(size * jax.random.uniform(kc2, (batch, 2), minval=0.05,
                                            maxval=0.22))
        col.append(jax.random.uniform(kc3, (batch, 1, 1, 3)))
    arrs = [poses, betas, colors, R, dz, dxy, coarse, bright, contr, gain,
            jnp.stack(cxy), jnp.stack(wh), jnp.stack(col)]
    return ttrain.SynthDraws(*[torch.as_tensor(np.asarray(a)) for a in arrs])


@pytest.fixture(scope="module")
def bodies():
    return (jparams.synthetic(n_joints=24, n_verts=300, seed=0),
            tparams.synthetic(n_joints=24, n_verts=300, seed=0))


def test_project_like_render(bodies):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 7, 3)).astype(np.float32)
    cam = np.array([[0.1, -0.2, 3.0], [0.0, 0.3, 2.5]], np.float32)
    want = np.stack([np.asarray(jtrain.project_like_render(
        jnp.asarray(p), jnp.asarray(c), 150.0, 64, 48))
        for p, c in zip(pts, cam)])
    got = ttrain.project_like_render(torch.as_tensor(pts),
                                     torch.as_tensor(cam)[:, None, :],
                                     150.0, 64, 48).numpy()
    np.testing.assert_allclose(got, want, atol=KP_ATOL)


@pytest.mark.parametrize("n_out", [48, 64, 128])
def test_cubic_resize_matches_jax(n_out):
    coarse = np.random.default_rng(1).uniform(size=(2, 6, 6, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(coarse),
                                       (2, n_out, n_out, 3), "cubic"))
    W = ttrain.cubic_resize_matrix(6, n_out)
    got = torch.einsum("yi,bijc,xj->byxc", W, torch.as_tensor(coarse),
                       W).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("size,domain_rand", [(48, False), (64, True)])
def test_synthesizer_same_draws(bodies, size, domain_rand):
    jbody, tbody = bodies
    key = jax.random.PRNGKey(3)
    batch = 2
    want = jtrain.make_synthesizer(jbody, size=size,
                                   domain_rand=domain_rand)(key, batch)
    synth = ttrain.make_synthesizer(tbody, size=size,
                                    domain_rand=domain_rand)
    got = synth.render(jax_draws(synth, key, batch, tbody))
    np.testing.assert_allclose(got.keypoints.numpy(),
                               np.asarray(want.keypoints), atol=KP_ATOL)
    img_t, img_j = got.images.numpy(), np.asarray(want.images)
    assert img_t.shape == img_j.shape == (batch, size, size, 3)
    off = np.abs(img_t - img_j).max(axis=-1) > IMG_ATOL
    assert off.mean() <= IMG_SHARE, off.mean()
    fg = np.abs(img_j - img_j[:, :1, :1]).max(axis=-1) > 0.05
    assert fg.mean() > 0.01                       # the body rendered
    np.testing.assert_allclose(got.global_R.numpy(),
                               np.asarray(want.global_R), atol=1e-6)


def test_draws_are_seeded_and_device_free(bodies):
    _, tbody = bodies
    synth = ttrain.make_synthesizer(tbody, size=48, domain_rand=True)
    a = synth.draw(torch.Generator().manual_seed(7), 3)
    b = synth.draw(torch.Generator().manual_seed(7), 3)
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and torch.equal(x, y)
    assert a.occ_cxy.shape == (2, 3, 2)
    data = synth.render(a)
    assert data.images.shape == (3, 48, 48, 3)
    assert float(data.images.min()) >= 0 and float(data.images.max()) <= 1


def test_detector_improves_on_synthetic():
    """tpubody's recipe (its slow test): 30 steps at 48^2 on the
    200-vertex synthetic body (under the humanoid's minimum); chunk 8 runs
    32 steps and records 30."""
    seen = []
    res = ttrain.train_pose2d_synthetic(
        steps=30, batch=4, size=48, n_verts=200, features=8, lr=2e-3,
        chunk=8, device="cpu", on_chunk=lambda sd, done: seen.append(done))
    assert len(res.losses) == 30 and np.isfinite(res.losses).all()
    assert seen == [8, 16, 24, 32]
    assert res.losses[-1] < res.losses[0]
    assert res.pixel_err_after < res.pixel_err_before
