"""tpubody_torch.render.camera against tpubody.render.camera on seeded
inputs.  Both sides are float32 elementwise math and 3x3 solves: outputs
are held to 1e-5 relative to their magnitude (pixels reach ~1e3, so the
absolute bar scales with the largest reference value)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.render import camera as JC
from tpubody_torch.render import camera as TC

torch.set_num_threads(1)

RTOL = 1e-5


def t(x):
    return torch.as_tensor(x)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    qb = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                   for _ in range(2)])
    pts = rng.normal(size=(2, 17, 3)).astype(f32)
    pts[..., 2] += 4.0
    j3 = rng.normal(scale=0.4, size=(17, 3)).astype(f32)
    true_t = np.array([0.1, -0.2, 3.0], f32)
    cen = np.array([128.0, 120.0], f32)
    j2 = (500.0 * (j3[:, :2] + true_t[:2]) / (j3[:, 2:] + true_t[2]) + cen
          + rng.normal(scale=0.5, size=(17, 2))).astype(f32)
    return dict(
        pts=pts, R=q.astype(f32), Rb=qb.astype(f32),
        T=rng.normal(size=3).astype(f32),
        tb=(rng.normal(size=(2, 3)) + [0, 0, 5.0]).astype(f32),
        K=(500.0, 510.0, 128.0, 120.0),
        centers=rng.uniform(100, 200, size=(2, 2)).astype(f32),
        cam=np.abs(rng.normal(size=(4, 3))).astype(f32) + 0.3,
        crop_center=rng.uniform(50, 400, size=(4, 2)).astype(f32),
        scale=rng.uniform(0.8, 2.0, size=4).astype(f32),
        j3=j3, j2=j2, conf=rng.uniform(0.2, 1.0, size=17).astype(f32),
        cen=cen)


def _world_to_cam(mod, a, d):
    return mod.world_to_cam(a(d["pts"]), a(d["R"]), a(d["T"]))


def _cam_to_pixel(mod, a, d):
    pts = d["pts"].copy()
    pts[0, 0, 2] = 0.0                   # the guarded divide
    pts[0, 1, 2] = -1e-9
    return mod.cam_to_pixel(a(pts), mod.Intrinsics.make(*d["K"]))


def _project_points(mod, a, d):
    K = mod.Intrinsics.make(*d["K"])
    return mod.project_points(a(d["pts"]), K, a(d["R"]), a(d["T"]))


def _project_points_defaults(mod, a, d):
    return mod.project_points(a(d["pts"]), mod.Intrinsics.make(*d["K"]))


def _perspective_scalar_f(mod, a, d):
    return mod.perspective_projection(a(d["pts"]), a(d["Rb"]), a(d["tb"]),
                                      500.0, a(d["centers"]))


def _perspective_batched_f(mod, a, d):
    return mod.perspective_projection(
        a(d["pts"]), a(d["Rb"]), a(d["tb"]),
        a(np.array([500.0, 650.0], np.float32)), a(d["centers"]))


def _weak_perspective(mod, a, d):
    return mod.weak_perspective_translation(a(d["cam"]), 5000.0, 224.0)


def _crop_cam_to_orig(mod, a, d):
    return mod.crop_cam_to_orig(a(d["cam"]), d["crop_center"], d["scale"],
                                5000.0, np.array([320.0, 240.0], np.float32))


def _estimate_translation(mod, a, d):
    return mod.estimate_translation(a(d["j3"]), a(d["j2"]), a(d["conf"]),
                                    500.0, a(d["cen"]))


def _ortho(mod, a, d):
    cam = mod.OrthoCamera(scale=a(np.float32(120.0)),
                          center=a(np.array([64.0, 60.0], np.float32)),
                          flip_y=True)
    return cam.to_screen(a(d["pts"]))


def _ortho_no_flip(mod, a, d):
    cam = mod.OrthoCamera(scale=a(np.float32(80.0)),
                          center=a(np.array([10.0, 20.0], np.float32)))
    return cam.to_screen(a(d["pts"][0]))


CASES = [_world_to_cam, _cam_to_pixel, _project_points,
         _project_points_defaults, _perspective_scalar_f,
         _perspective_batched_f, _weak_perspective, _crop_cam_to_orig,
         _estimate_translation, _ortho, _ortho_no_flip]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__.lstrip("_"))
def test_camera_function_matches(case):
    d = _inputs()
    want = np.asarray(case(JC, jnp.asarray, d))
    got = case(TC, t, d)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    bar = RTOL * max(1.0, float(np.abs(want[finite]).max()))
    if case is _estimate_translation:
        # a 3x3 solve of normal equations with entries ~1e7: its float32
        # conditioning, not the port, sets the error (both ~1e-3 of truth)
        bar = 1e-3
        assert np.abs(got.numpy() - [0.1, -0.2, 3.0]).max() < 0.05
    assert np.abs(got.numpy()[finite] - want[finite]).max() <= bar


def test_intrinsics_fields():
    K = TC.Intrinsics.make(500.0, 510.0, 128.0, 120.0)
    assert K._fields == JC.Intrinsics._fields
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in K)
    assert TC.OrthoCamera._fields == JC.OrthoCamera._fields
