"""Shared inputs of the reconstruct slice's parity tests
(tests/test_torch_{reconstruct,stitch,rig_mesh}.py): tpubody's device
stages on the 1100-vertex humanoid in the demo pose at 128x128, the photo
mask rendered at other betas than the fit's, so the warp moves pixels.

``use_native_geometry`` makes tpubody's host-geometry calls take the C++
path through the port's build of the same source (``geometry.cpp`` is a
copy; only its tracer's stop on two-pixel regions differs, which no mesh
function reaches): ``tpubody/native`` builds without a lock, so on a test worker that
lost the build race tpubody would take its Python paths, whose boundary
edges come in another order (and so another ring start).  The stitched
mesh is compared on one path, whatever the race did.
"""
import jax.numpy as jnp
import numpy as np

from tpubody.image import warp as JW
from tpubody.models import humanoid as JH
from tpubody.models import smpl as JS
from tpubody.pipelines import demo as jdemo
from tpubody.pipelines import reconstruct as JR
from tpubody.render import bodymaps as JB
from tpubody.render import camera as JC
from tpubody.solve import normal2depth as JN

SIZE = 128
N_VERTS = 1100
PHOTO_BETAS = np.array([0.6, 1.5, 0, 0, 0, 0, 0, 0, 0, 0], np.float64)


def use_native_geometry(monkeypatch) -> None:
    """tpubody.native answers from the port's loaded helper library."""
    import tpubody.native as jnative
    from tpubody_torch import geometry

    monkeypatch.setattr(jnative, "_lib", geometry.library())


def use_python_geometry(monkeypatch) -> None:
    """tpubody.native reports no library: tpubody takes its Python paths."""
    import tpubody.native as jnative

    monkeypatch.setattr(jnative, "_load", lambda: None)


def jax_chain_data():
    """tpubody's stages 1-5 (reconstruct.py:105-210) and their inputs."""
    smplh, smpl = JH.humanoid(52, N_VERTS), JH.humanoid(24, N_VERTS)
    pose = jdemo.demo_pose(52, 0)

    def posed(betas):
        return JS.forward(smplh, jnp.asarray(pose, jnp.float32),
                          jnp.asarray(betas, jnp.float32))

    verts = np.asarray(posed(jdemo.DEMO_BETAS).verts)
    focal = 5000.0 * SIZE / 1024.0
    center = np.array([SIZE / 2.0, SIZE / 2.0])
    c = (verts.min(axis=0) + verts.max(axis=0)) / 2.0
    extent = float((verts.max(axis=0) - verts.min(axis=0))[:2].max()) * 1.35
    cam_t = np.array([-c[0], -c[1], extent * focal / (0.85 * SIZE) - c[2]])
    faces, weights = np.asarray(smplh.faces), np.asarray(smpl.weights)

    def render(v):
        return JB.render_body_maps(v, faces, weights, cam_t, center, SIZE,
                                   SIZE, focal=focal)

    mask = np.asarray(render(np.asarray(posed(PHOTO_BETAS).verts)).mask)
    mask_u8 = mask.astype(np.uint8) * 255
    fit = JR.FitResult(shape=jdemo.DEMO_BETAS, pose=pose.reshape(-1),
                       camera_center=center, camera_rotation=np.eye(3),
                       camera_translation=cam_t, camera_fx=focal)

    state_b = JS.forward(smpl, jnp.asarray(pose[:24], jnp.float32),
                         jnp.asarray(fit.shape, jnp.float32))
    K = JC.Intrinsics.make(focal, focal, center[0], center[1])
    J_2d = np.asarray(JC.project_points(
        JS.regress_joints(smpl, state_b.verts), K,
        jnp.eye(3, dtype=jnp.float32), jnp.asarray(cam_t, jnp.float32)))
    J_2d = np.clip(np.round(J_2d), 0, [SIZE - 1, SIZE - 1]).astype(int)
    value = np.asarray(render(verts).value)
    warp = JW.warp_stage(mask_u8, value)
    front, back = JN.normal2depth(jnp.asarray(warp.value)[..., :6],
                                  jnp.asarray(mask))
    # Seeded photos: the stitch carries their colours into the mesh.
    rng = np.random.default_rng(0)
    front_rgb = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    back_rgb = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    return dict(fit=fit, mask=mask, mask_u8=mask_u8, verts=verts,
                faces=faces, weights=weights, J_2d=J_2d, value=value,
                warp=warp, warp_value=np.asarray(warp.value),
                front=np.asarray(front), back=np.asarray(back),
                smplh=smplh, smpl=smpl, front_rgb=front_rgb,
                back_rgb=back_rgb)


def stitch_inputs(jc):
    """tpubody's stitch arguments, as its reconstruct builds them with the
    cache on (the weights straight from the warped map)."""
    return (jc["front"], jc["front_rgb"].astype(np.float32), jc["back"],
            jc["back_rgb"].astype(np.float32), jc["warp_value"][..., 6:],
            jc["J_2d"])
