"""tpubody_torch.render.raster against tpubody.render.raster on seeded
scenes (64x128, tens of faces).

Both sides evaluate the same float32 expressions, so coverage and winning
face ids must be equal at every pixel; interpolated values are held to
1e-5 (XLA may fuse a multiply-add where torch rounds twice)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.render import raster as JR
from tpubody_torch.render import raster as TR

torch.set_num_threads(1)

ATOL = 1e-5
H, W = 64, 128


def scene(n_faces, max_extent, seed, n_chan=5, H=H, W=W):
    """Random triangles with bounded projected extent, some offscreen (the
    generator of tests/test_pallas_raster.py)."""
    rng = np.random.default_rng(seed)
    V = n_faces
    verts = np.stack([rng.uniform(-20, W + 20, V), rng.uniform(-20, H + 20, V),
                      rng.uniform(1.0, 5.0, V)], 1).astype(np.float32)
    faces = rng.integers(0, V, (n_faces, 3)).astype(np.int32)
    tri = verts[faces]
    cent = tri.mean(1, keepdims=True)
    scale = np.minimum(
        1.0, max_extent / (np.abs(tri[..., :2] - cent[..., :2])
                           .max((1, 2), keepdims=True) * 2 + 1e-6))
    tri = cent + (tri - cent) * scale
    verts2 = tri.reshape(-1, 3).astype(np.float32)
    faces2 = np.arange(n_faces * 3).reshape(n_faces, 3).astype(np.int32)
    attrs = rng.uniform(size=(verts2.shape[0], n_chan)).astype(np.float32)
    return verts2, faces2, attrs


def assert_same_raster(got, want, atol=ATOL):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.face_id.numpy(),
                                  np.asarray(want.face_id))
    np.testing.assert_allclose(got.attrs.numpy(), np.asarray(want.attrs),
                               atol=atol)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(want.bary),
                               atol=atol)
    m = np.asarray(want.mask)
    np.testing.assert_allclose(got.depth.numpy()[m],
                               np.asarray(want.depth)[m], atol=atol)
    assert np.isinf(got.depth.numpy()[~m]).all()


def t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("seed,n_faces,ext,window,kw", [
    (0, 40, 12, 24, {}),
    (1, 60, 20, 32, {"cull_backface": True}),
    (2, 30, 10, 16, {"depth_ascending": False}),
    (3, 25, 40, 64, {}),          # window reaches past the frame's height
])
def test_rasterize_matches(seed, n_faces, ext, window, kw):
    v, f, a = scene(n_faces, ext, seed)
    want = JR.rasterize(jnp.asarray(v), jnp.asarray(f), jnp.asarray(a), H, W,
                        window=window, **kw)
    got = TR.rasterize(t(v), t(f), t(a), H, W, window=window, **kw)
    assert int(got.mask.sum()) > 100
    assert_same_raster(got, want)


def test_degenerate_and_offscreen_faces():
    v, f, a = scene(30, 10, 2)
    v[:9] = [[-500, -500, 1]] * 9        # offscreen
    v[9:12] = [[5.0, 5.0, 1.0]] * 3      # zero area
    want = JR.rasterize(jnp.asarray(v), jnp.asarray(f), jnp.asarray(a), H, W,
                        window=16)
    got = TR.rasterize(t(v), t(f), t(a), H, W, window=16)
    assert torch.isfinite(got.attrs).all()
    assert_same_raster(got, want)


def test_shade_from_zbuf_matches():
    v, f, a = scene(40, 12, 5)
    fb = TR._face_bits(f.shape[0])
    assert fb == JR._face_bits(f.shape[0])
    rng = np.random.default_rng(6)
    # a synthetic z-buffer: random winners with random depths, some empty
    fid = rng.integers(0, f.shape[0], size=(H, W))
    dq = rng.integers(0, 1 << (31 - fb), size=(H, W))
    z = ((dq << fb) | fid).astype(np.int32)
    z[rng.uniform(size=(H, W)) < 0.3] = TR.INT32_MAX
    want = JR.shade_from_zbuf(jnp.asarray(z), jnp.asarray(v), jnp.asarray(f),
                              jnp.asarray(a), H, W)
    got = TR.shade_from_zbuf(t(z), t(v), t(f), t(a), H, W)
    assert_same_raster(got, want)


def test_merge_rasters_and_binned_match():
    v, f, a = scene(40, 30, 7)
    small, large = TR.split_faces_by_extent(v, f, 16, pad_multiple=8)
    js, jl = JR.split_faces_by_extent(v, f, 16, pad_multiple=8)
    np.testing.assert_array_equal(small, js)
    np.testing.assert_array_equal(large, jl)
    want = JR.rasterize_binned(jnp.asarray(v), jnp.asarray(small),
                               jnp.asarray(large), jnp.asarray(a), H, W,
                               small_window=16, large_window=48)
    got = TR.rasterize_binned(t(v), t(small), t(large), t(a), H, W,
                              small_window=16, large_window=48)
    assert_same_raster(got, want)
    assert int((got.face_id >= small.shape[0]).sum()) > 0   # offset applied


@pytest.mark.parametrize("batch", [(), (3,)])
def test_vertex_normals_match(batch):
    rng = np.random.default_rng(8)
    verts = rng.normal(size=batch + (50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, size=(90, 3)).astype(np.int32)
    got = TR.vertex_normals(t(verts), t(faces)).numpy()
    flat = verts.reshape((-1, 50, 3))
    want = np.stack([np.asarray(JR.vertex_normals(jnp.asarray(x),
                                                  jnp.asarray(faces)))
                     for x in flat]).reshape(verts.shape)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("with_bg", [False, True])
def test_shade_lambert_matches(with_bg):
    v, f, a = scene(40, 12, 9, n_chan=6)
    a[:, 3:] -= 0.5                               # signed "normals"
    jout = JR.rasterize(jnp.asarray(v), jnp.asarray(f), jnp.asarray(a), H, W,
                        window=24)
    tout = TR.rasterize(t(v), t(f), t(a), H, W, window=24)
    bg = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)
    want = JR.shade_lambert(jout, jout.attrs[..., 3:6], jout.attrs[..., :3],
                            light_dir=(0.3, 0.3, -1.0),
                            background=jnp.asarray(bg) if with_bg else None)
    got = TR.shade_lambert(tout, tout.attrs[..., 3:6], tout.attrs[..., :3],
                           light_dir=(0.3, 0.3, -1.0),
                           background=t(bg) if with_bg else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_shift_key_wraps_like_int32():
    dq = np.array([0, 1, (1 << 25) - 1, 1 << 25, (1 << 26) - 1], np.int32)
    want = np.asarray(jnp.asarray(dq) << 6)
    np.testing.assert_array_equal(TR.shift_key(t(dq), 6).numpy(), want)
    assert want[3] == np.iinfo(np.int32).min
