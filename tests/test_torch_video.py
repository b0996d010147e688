"""tpubody_torch.render.video against tpubody.render.video on the sphere
avatar at 128x128 (tpubody's Pallas kernel runs in interpret mode on the
CPU).

Tolerances:
  * host-side planning (``plan_tiled_render``, ``_tile_occupancy``,
    ``_chunk_budget``, ``auto_window``) is float64 numpy on both sides:
    equal;
  * ``rgb_to_i420`` and ``quantize_u8`` on seeded input: byte-equal (the
    same float32 expressions, truncation after ``+ 0.5``);
  * uint8 frames: within 1 LSB on at least 99.9% of the values (float32
    sums in another order move a value across a rounding step; the rest
    are sub-pixel edge pixels where the two kernels' summation orders
    decide coverage differently);
  * float frames of the fragment renderer: 1e-5 off the edge pixels.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.mesh import rigging as jrigging
from tpubody.render import video as JV
from tpubody_torch.mesh import rigging as trigging
from tpubody_torch.render import video as TV

from tests.test_torch_rigging import both_avatars

torch.set_num_threads(1)

SIZE, FOCAL = 128, 300.0
CAM = np.array([0.0, 0.0, 3.0])
LSB_SHARE = 0.999


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x, dtype) if dtype else x)


def posed(n=2, seed=4):
    """(jax avatar, torch avatar, posed vertices (n, V, 3) float32)."""
    jav, tav = both_avatars()
    rng = np.random.default_rng(seed)
    poses = rng.normal(scale=0.1, size=(n, 24, 3))
    verts = trigging.animate(tav, poses, np.zeros((n, 3)), device="cpu")
    return jav, tav, verts.numpy()


def assert_plans_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k in ("large_buckets", "ladder_faces"):
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        elif isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        else:
            assert got[k] == want[k], k


def big_face_mesh():
    """The sphere plus 12 large near triangles (the occluders of
    tests/test_animate.py): faces for the ladder and the fragment path."""
    _, tav = both_avatars()
    rng = np.random.default_rng(0)
    base = tav.v_template.shape[0]
    pts, faces = [], []
    for i in range(12):
        c = rng.uniform(-0.2, 0.0, 2)
        pts += [[c[0], 0.6, c[1]], [c[0] + 0.5, 0.6, c[1]],
                [c[0], 0.6, c[1] + 0.5]]
        faces.append([base + 3 * i, base + 3 * i + 1, base + 3 * i + 2])
    verts = np.concatenate([tav.v_template, np.asarray(pts)])
    faces = np.concatenate([tav.faces, np.asarray(faces, np.int64)])
    colors = np.concatenate([tav.color, np.tile([[1.0, 0.0, 0.0]], (36, 1))])
    return verts, faces, colors


@pytest.mark.parametrize("case", ["sphere", "big_faces", "no_ladder",
                                  "close_camera"])
def test_plan_tiled_render_equal(case):
    _, tav = both_avatars()
    verts, faces = tav.v_template, tav.faces
    kw = {}
    cam, size, focal = CAM, SIZE, FOCAL
    if case in ("big_faces", "no_ladder"):
        verts, faces, _ = big_face_mesh()
    if case == "no_ladder":
        kw["ladder_bounds"] = ()
    if case == "close_camera":
        cam, size, focal = np.array([0.0, 0.0, 1.2]), 256, 900.0
    want = JV.plan_tiled_render(verts, faces, cam, size, size, focal, **kw)
    got = TV.plan_tiled_render(verts, faces, cam, size, size, focal, **kw)
    assert_plans_equal(got, want)
    if case == "big_faces":
        assert got["ladder_faces"] and not got["large_buckets"]
    if case == "no_ladder":
        assert got["large_buckets"]


def test_fragment_buckets_respect_the_budget(monkeypatch):
    verts, faces, _ = big_face_mesh()
    for mod in (JV, TV):
        monkeypatch.setattr(mod, "FRAG_BUDGET", 3 * 72 * 72)
    want = JV.plan_tiled_render(verts, faces, CAM, SIZE, SIZE, FOCAL,
                                ladder_bounds=())
    got = TV.plan_tiled_render(verts, faces, CAM, SIZE, SIZE, FOCAL,
                               ladder_bounds=())
    assert_plans_equal(got, want)
    assert len(got["large_buckets"]) >= 2


def test_tile_occupancy_chunk_budget_auto_window_equal():
    rng = np.random.default_rng(1)
    tri = rng.uniform(-30, 300, size=(500, 3, 2))
    tri = tri[:, :1] + (tri - tri[:, :1]) * 0.1
    for sx, sy in ((2, 5), (3, 13)):
        want = JV._tile_occupancy(tri, sx, sy, 256, 256)
        got = TV._tile_occupancy(tri, sx, sy, 256, 256)
        np.testing.assert_array_equal(got, want)
        assert got.sum() > 500
        for slack in (1.0, 1.4):
            assert TV._chunk_budget(got, slack) == JV._chunk_budget(want,
                                                                    slack)
    empty = np.zeros((0, 3, 2))
    np.testing.assert_array_equal(TV._tile_occupancy(empty, 2, 5, 128, 128),
                                  JV._tile_occupancy(empty, 2, 5, 128, 128))
    _, tav = both_avatars()
    for cam, size, focal in ((CAM, 128, 300.0),
                             (np.array([0.0, 0.0, 10.0]), 256, 300.0),
                             (np.array([0.0, 0.0, 1.5]), 1024, 2500.0)):
        assert TV.auto_window(tav.v_template, tav.faces, cam, size, size,
                              focal) == \
            JV.auto_window(tav.v_template, tav.faces, cam, size, size, focal)


def test_rgb_to_i420_byte_equal():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, size=(2, 3, 16, 32)).astype(np.float32)
    img[0, :, :4] = 1.0                         # white, and black
    img[0, :, 4:8] = 0.0
    want = np.asarray(JV.rgb_to_i420(jnp.asarray(img)))
    got = TV.rgb_to_i420(t(img))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 24, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_u8_equal():
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.2, 1.2, size=(8, 8, 3)).astype(np.float32)
    x[0, 0] = [0.5 / 255.0, 1.0, 127.5 / 255.0]
    np.testing.assert_array_equal(TV.quantize_u8(x), JV.quantize_u8(x))
    u = (x.clip(0, 1) * 255).astype(np.uint8)
    assert TV.quantize_u8(u) is u
    # the device rule: truncation after + 0.5
    dev = (torch.clamp(t(x), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    np.testing.assert_array_equal(dev.numpy(), TV.quantize_u8(x))


def test_constants_and_camera_fields():
    np.testing.assert_array_equal(TV._PRE_ROT, JV._PRE_ROT)
    np.testing.assert_array_equal(TV._FLIP_YZ, JV._FLIP_YZ)
    assert TV.FrameCamera._fields == JV.FrameCamera._fields
    assert (TV.DEFAULT_SIZE, TV.DEFAULT_FOCAL, TV.FRAG_BUDGET) == \
        (JV.DEFAULT_SIZE, JV.DEFAULT_FOCAL, JV.FRAG_BUDGET)


def test_screen_bbox_matches():
    jav, tav, verts = posed(3)
    for cam in (CAM.astype(np.float32),
                np.stack([CAM, CAM + 0.1, CAM - 0.1]).astype(np.float32)):
        if cam.ndim == 2:
            # per-frame translations broadcast over vertices on both sides
            want = np.asarray(JV.screen_bbox(
                jnp.asarray(verts), jnp.asarray(cam)[:, None, :], SIZE, SIZE,
                FOCAL))
        else:
            want = np.asarray(JV.screen_bbox(jnp.asarray(verts),
                                             jnp.asarray(cam), SIZE, SIZE,
                                             FOCAL))
        got = TV.screen_bbox(t(verts), t(cam), SIZE, SIZE, FOCAL)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def _edge_free(a, b, atol):
    """Share of values of a within atol of b."""
    return float((np.abs(a.astype(np.float64) - b) <= atol).mean())


def test_render_frames_fragment_path_matches():
    jav, tav, verts = posed(2)
    bg = np.random.default_rng(2).uniform(size=(SIZE, SIZE, 3)
                                          ).astype(np.float32)
    w = TV.auto_window(tav.v_template, tav.faces, CAM, SIZE, SIZE, FOCAL)
    want = np.asarray(JV.render_frames(
        jnp.asarray(verts), jnp.asarray(jav.faces, jnp.int32),
        jnp.asarray(jav.color, jnp.float32), jnp.asarray(CAM, jnp.float32),
        jnp.asarray(bg), height=SIZE, width=SIZE, focal=FOCAL, window=w))
    got = TV.render_frames(
        t(verts), t(tav.faces, np.int32), t(tav.color, np.float32),
        t(CAM, np.float32), t(bg), height=SIZE, width=SIZE, focal=FOCAL,
        window=w).numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    assert _edge_free(got, want, 1e-5) >= LSB_SHARE
    one = TV.render_frame(
        t(verts[1]), t(tav.faces, np.int32), t(tav.color, np.float32),
        t(CAM, np.float32), t(bg), height=SIZE, width=SIZE, focal=FOCAL,
        window=w).numpy()
    np.testing.assert_array_equal(one, got[1])
    assert (np.abs(got[0] - bg) > 1e-3).any(axis=-1).mean() > 0.05


def test_render_frame_binned_matches_plain():
    _, tav, verts = posed(1)
    size = 96
    v = (verts[0] @ TV._PRE_ROT.T + CAM) @ TV._FLIP_YZ.T
    z = np.maximum(-v[:, 2], 1e-6)
    screen = np.stack([v[:, 0] / z * 150.0 + size / 2,
                       -v[:, 1] / z * 150.0 + size / 2, z], axis=1)
    from tpubody_torch.render import raster as raster_lib

    sf, lf = raster_lib.split_faces_by_extent(screen, tav.faces, 16)
    bg = torch.ones((size, size, 3))
    args = (t(tav.color, np.float32), t(CAM, np.float32), bg)
    plain = TV.render_frame(t(verts[0]), t(tav.faces, np.int32), *args,
                            height=size, width=size, focal=150.0, window=96)
    binned = TV.render_frame_binned(
        t(verts[0]), t(sf, np.int32), t(lf, np.int32),
        t(tav.faces, np.int32), *args, height=size, width=size, focal=150.0,
        small_window=16, large_window=96)
    assert ((plain - binned).abs() < 1e-4).float().mean() > 0.999


def _tiled_args(verts, faces, colors, plan, conv, arr):
    lb = tuple(arr(b) for b in plan["large_buckets"]) or None
    lad = tuple(arr(b) for b in plan["ladder_faces"])
    args = (conv(verts, np.float32), arr(plan["small_faces"]), lb,
            arr(np.asarray(faces, np.int32)), conv(colors, np.float32),
            conv(CAM, np.float32))
    kw = dict(height=SIZE, width=SIZE, focal=FOCAL,
              max_chunks=plan["max_chunks"], span_x=plan["span_x"],
              span_y=plan["span_y"], total_chunks=plan["total_chunks"],
              large_windows=plan["large_windows"], ladder_faces=lad,
              ladder_specs=plan["ladder_specs"])
    return args, kw


def _both_tiled(verts, faces, colors, plan, bg, **opts):
    jargs, jkw = _tiled_args(verts, faces, colors, plan,
                             lambda x, d: jnp.asarray(np.asarray(x, d)),
                             jnp.asarray)
    targs, tkw = _tiled_args(verts, faces, colors, plan, t, torch.as_tensor)
    want = np.asarray(JV.render_frames_tiled(*jargs, jnp.asarray(bg), **jkw,
                                             **opts))
    got = TV.render_frames_tiled(*targs, t(bg), **tkw, **opts)
    return got, want


@pytest.mark.parametrize("shading,opts", [
    ("phong", {}),
    ("gouraud", {"channel_major_out": True}),
])
def test_render_frames_tiled_matches_tpubody(shading, opts):
    _, tav, verts = posed(2)
    plan = TV.plan_tiled_render(tav.v_template, tav.faces, CAM, SIZE, SIZE,
                                FOCAL)
    bg = np.random.default_rng(3).uniform(0.6, 1.0, size=(SIZE, SIZE, 3)
                                          ).astype(np.float32)
    got, want = _both_tiled(verts, tav.faces, tav.color, plan, bg,
                            shading=shading, **opts)
    assert got.dtype == torch.uint8
    shape = (2, 3, SIZE, SIZE) if opts else (2, SIZE, SIZE, 3)
    assert tuple(got.shape) == want.shape == shape
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert (d <= 1).mean() >= LSB_SHARE, (d <= 1).mean()
    body = np.abs(want.astype(int)
                  - (np.moveaxis(bg, -1, 0) if opts else bg) * 255) > 2
    assert body.mean() > 0.05                       # the body is in frame

    # the same frames as planar I420 and as floats, from the port alone:
    # consistent with the uint8 frames
    targs, tkw = _tiled_args(verts, tav.faces, tav.color, plan, t,
                             torch.as_tensor)
    flt = TV.render_frames_tiled(*targs, t(bg), **tkw, shading=shading,
                                 to_uint8=False, channel_major_out=True)
    u8 = got if opts else got.permute(0, 3, 1, 2)
    np.testing.assert_array_equal(TV.quantize_u8(flt.numpy()), u8.numpy())
    planes = TV.render_frames_tiled(*targs, t(bg), **tkw, shading=shading,
                                    i420_out=True)
    assert torch.equal(planes, TV.rgb_to_i420(flt))
    with pytest.raises(ValueError, match="shading"):
        TV.render_frames_tiled(*targs, t(bg), **tkw, shading="flat")


def test_render_frames_tiled_ladder_and_fragment_buckets():
    """Over-span faces through the ladder's tiled passes and, with the
    ladder off, through the fragment buckets: both composite to the image
    the fragment renderer gives (the bar of tests/test_animate.py: more
    than 99.5% of values within 2e-2)."""
    verts, faces, colors = big_face_mesh()
    bg = np.ones((SIZE, SIZE, 3), np.float32)
    w = TV.auto_window(verts, faces, CAM, SIZE, SIZE, FOCAL)
    frag = TV.render_frames(
        t(verts[None], np.float32), t(faces, np.int32),
        t(colors, np.float32), t(CAM, np.float32), t(bg), height=SIZE,
        width=SIZE, focal=FOCAL, window=w).numpy()[0]
    red = (frag[..., 0] > 0.5) & (frag[..., 1] < 0.3)
    assert red.sum() > 100                          # the occluders won
    for kw in ({}, {"ladder_bounds": ()}):
        plan = TV.plan_tiled_render(verts, faces, CAM, SIZE, SIZE, FOCAL,
                                    **kw)
        targs, tkw = _tiled_args(verts[None], faces, colors, plan, t,
                                 torch.as_tensor)
        tiled = TV.render_frames_tiled(*targs, t(bg), **tkw,
                                       to_uint8=False).numpy()[0]
        agree = np.isclose(tiled, frag, atol=2e-2).mean()
        assert agree > 0.995, (kw, agree)
