"""tpubody_torch.render.bodymaps against tpubody.render.bodymaps on the
1100-vertex humanoid in the demo pose, on the CPU: a tileable size (128x128,
the fused tiled rasterizer; tpubody's Pallas kernel in interpret mode) and
one that does not tile (100x120, the fragment rasterizer).

Tolerances: masks equal; background exactly 1.0; values within 2e-5 where
both cover (the bar of tests/test_torch_tiled_raster.py for attributes: one
float32 rounding that the two summation orders do not share), except on the
fingers, whose faces are smaller than a pixel at this size: their affine
slopes (~ 1 / area) reach O(30), so the same one rounding is worth up to
3e-5 there.  At most 0.1% of the values may pass 2e-5, and none 1e-4."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.pipelines import demo as jdemo
from tpubody.render import bodymaps as JB
from tpubody_torch.models import humanoid, smpl
from tpubody_torch.render import bodymaps as TB

torch.set_num_threads(1)
VALUE_ATOL = 2e-5
SLIVER_ATOL = 1e-4        # sub-pixel finger faces, see the docstring
SLIVER_SHARE = 1e-3


def fixture(height, width, n_verts=1100, betas=None):
    """The demo fixture's body and camera (tpubody.pipelines.demo
    make_fixture), from the port's humanoid: posed verts, faces, the
    24-joint weights, camera translation, centre and focal."""
    smplh = humanoid.humanoid(52, n_verts, device="cpu")
    smpl24 = humanoid.humanoid(24, n_verts, device="cpu")
    betas = jdemo.DEMO_BETAS if betas is None else betas
    pose = jdemo.demo_pose(52, 0)
    v = smpl.forward(smplh, torch.as_tensor(pose, dtype=torch.float32),
                     torch.as_tensor(betas, dtype=torch.float32)
                     ).verts.numpy()
    size = min(height, width)
    focal = 5000.0 * size / 1024.0
    center = np.array([width / 2.0, height / 2.0])
    c = (v.min(axis=0) + v.max(axis=0)) / 2.0
    extent = float((v.max(axis=0) - v.min(axis=0))[:2].max()) * 1.35
    cam_t = np.array([-c[0], -c[1], extent * focal / (0.85 * size) - c[2]])
    return dict(verts=v, faces=np.asarray(smplh.faces),
                weights=smpl24.weights.numpy(), cam_t=cam_t, center=center,
                focal=focal, pose=pose, betas=betas, smplh=smplh,
                smpl=smpl24)


def test_project_to_screen():
    fx = fixture(128, 128)
    want = np.asarray(JB.project_to_screen(
        jnp.asarray(fx["verts"]), jnp.asarray(fx["cam_t"], jnp.float32),
        jnp.asarray(fx["center"], jnp.float32), fx["focal"]))
    got = TB.project_to_screen(
        torch.as_tensor(fx["verts"]),
        torch.as_tensor(fx["cam_t"], dtype=torch.float32),
        torch.as_tensor(fx["center"], dtype=torch.float32), fx["focal"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert want[:, 0].min() > 0 and want[:, 0].max() < 128


@pytest.mark.parametrize("H,W", [(128, 128), (100, 120)])
def test_render_body_maps(H, W):
    fx = fixture(H, W)
    args = (fx["verts"], fx["faces"], fx["weights"], fx["cam_t"],
            fx["center"], H, W)
    want = JB.render_body_maps(*args, focal=fx["focal"])
    got = TB.render_body_maps(*args, focal=fx["focal"], device="cpu")
    assert tuple(got.value.shape) == (H, W, 30)
    assert got.value.dtype == torch.float32 and got.mask.dtype == torch.bool
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0.05 < got.mask.float().mean() < 0.6
    for name in ("front_normal", "back_normal", "weight_map", "value"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        bg_a, bg_b = (a == 1.0).all(-1), (b == 1.0).all(-1)
        np.testing.assert_array_equal(bg_a, bg_b)
        np.testing.assert_allclose(a, b, atol=SLIVER_ATOL)
        assert (np.abs(a - b) > VALUE_ATOL).mean() <= SLIVER_SHARE
    m = got.mask.numpy()
    w = got.weight_map.numpy()
    np.testing.assert_allclose(w[m].sum(-1), 1.0, atol=1e-4)
    assert (got.value.numpy()[~m][:, :3] == 1.0).all()
    # the silhouette of the value map is front AND back coverage
    from tpubody_torch.image import warp
    sil = warp.silhouette_from_value(got.value).numpy()
    assert (sil <= m).all() and sil.sum() > 0.97 * m.sum()


def test_render_body_maps_takes_tensors():
    fx = fixture(128, 128)
    a = TB.render_body_maps(fx["verts"], fx["faces"], fx["weights"],
                            fx["cam_t"], fx["center"], 128, 128,
                            focal=fx["focal"], device="cpu")
    b = TB.render_body_maps(torch.as_tensor(fx["verts"]), fx["faces"],
                            torch.as_tensor(fx["weights"]), fx["cam_t"],
                            fx["center"], 128, 128, focal=fx["focal"],
                            device="cpu")
    assert torch.equal(a.value, b.value)


def test_fragment_and_tiled_channels_agree():
    """The two renderers of the port on the same pass: coverage equal,
    values within the fragment path's own 1e-3 (exact barycentrics vs
    affine planes evaluated in tile-local coordinates)."""
    fx = fixture(128, 128)
    v = torch.as_tensor(fx["verts"])
    screen = TB.project_to_screen(
        v, torch.as_tensor(fx["cam_t"], dtype=torch.float32),
        torch.as_tensor(fx["center"], dtype=torch.float32), fx["focal"])
    f = torch.as_tensor(fx["faces"].astype(np.int32))
    w = torch.as_tensor(fx["weights"])
    tiled, m1 = TB._render_channels_tiled(screen, f, w, 128, 128)
    frag, m2 = TB._render_channels(screen, f, w, 128, 128, 32, 1.0)
    assert torch.equal(m1, m2)
    np.testing.assert_allclose(tiled.numpy(), frag.numpy(), atol=1e-3)


def test_weights_to_rgb():
    wm = np.random.default_rng(0).random((16, 20, 24)).astype(np.float32)
    np.testing.assert_allclose(
        TB.weights_to_rgb(torch.as_tensor(wm)).numpy(),
        np.asarray(JB.weights_to_rgb(jnp.asarray(wm))), atol=1e-5)


def test_face_normals_z_and_divide_face():
    """The front/back split: z of the face normals within 1e-6 (one
    float32 product difference), and the same partition, vertex order and
    re-indexing as tpubody's divide_face."""
    from tpubody.models import smpl as JS

    fx = fixture(128, 128)
    v, f = fx["verts"], fx["faces"]
    want = np.asarray(JS.face_normals_z(jnp.asarray(v), f))
    got = smpl.face_normals_z(torch.as_tensor(v), f).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert ((got <= 0) == (want <= 0)).all() and 0 < (got <= 0).sum() < len(f)
    batched = smpl.face_normals_z(torch.as_tensor(np.stack([v, -v])), f)
    np.testing.assert_allclose(batched[1].numpy(), got, atol=1e-6)
    for a, b in zip(smpl.divide_face(v, f), JS.divide_face(v, f)):
        np.testing.assert_array_equal(a, np.asarray(b))
    front, back = TB._front_back_faces(torch.as_tensor(v), f.astype(np.int32))
    assert front.shape == back.shape == f.shape
    n_front = int((got <= 0).sum())
    np.testing.assert_array_equal(front[:n_front].numpy(), f[got <= 0])
    assert (front[n_front:] == 0).all()
