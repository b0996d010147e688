"""The fitting pipeline and its artifact set against tpubody's:
pipelines.gen_smplh on a fixture the test writes (a cv2 image and an
OpenPose JSON from write_openpose_json, the VPoser snapshot as a
reference-layout .pt), then serving.fit_smplh_step through
InferenceServer, pipelines.refine, render.viewer, mesh.meshio and
image.ops.

gen_smplh: conf.yaml must be equal; smplh.pkl and pre_smplh.pkl hold the
fit under the whole-fit bar (loss rtol 1e-3; pose, betas, camera within
1e-3, maxiters=2); smplh.obj and the overlay PNG must exist, the overlay
within 2/255 of tpubody's on 99% of its pixels.  Served fits equal
BatchFitter.apply's within 1e-6.  tpubody's gen_smplh runs once, in a
module-scoped fixture (about 30 s of compile on the CPU).
"""
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from tests import torch_fit_common as common
from tpubody.fit import smplify as js
from tpubody.pipelines import gen_smplh as jgen
from tpubody_torch.fit import keypoints as tkp
from tpubody_torch.fit import smplify as ts
from tpubody_torch.image import ops as tops
from tpubody_torch.mesh import meshio as tmeshio
from tpubody_torch.pipelines import gen_smplh as tgen
from tpubody_torch.pipelines import reconstruct as trec
from tpubody_torch.pipelines import serving

torch.set_num_threads(1)

KW = dict(focal_length=common.FOCAL, maxiters=2)
ARTIFACTS = ["conf.yaml", "pre_smplh.pkl", "smplh.obj", "smplh.pkl",
             "smplh2rgb_rend.png"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    jm, tm = common.models()
    tree = common.decoder_tree()
    ckpt = str(d / "vposer.pt")
    common.write_vposer_ckpt(ckpt, tree, common.encoder_tree())
    kps = common.keypoints(jm, tree)
    img = np.random.default_rng(0).uniform(0, 255, (256, 256, 3)).astype(
        np.uint8)
    cv2.imwrite(str(d / "img.png"), img)
    k = kps[0].astype(np.float64)
    tkp.write_openpose_json(str(d / "kp.json"), k[:25], k[25:46], k[46:67])
    jgen.gen_smplh(str(d / "img.png"), str(d / "kp.json"), str(d / "jax"),
                   model=jm, config=js.FitConfig(**KW), vposer_ckpt=ckpt)
    fit = tgen.gen_smplh(str(d / "img.png"), str(d / "kp.json"),
                         str(d / "torch"), model=tm,
                         config=ts.FitConfig(**KW), vposer_ckpt=ckpt,
                         device="cpu")
    return d, tm, tree, kps, fit


def test_artifacts_and_config(fixture):
    d, _, _, _, _ = fixture
    assert sorted(os.listdir(d / "torch")) == ARTIFACTS
    assert sorted(os.listdir(d / "jax")) == ARTIFACTS
    assert (d / "torch" / "conf.yaml").read_text() == \
        (d / "jax" / "conf.yaml").read_text()
    cfg = tgen.load_config(str(d / "torch" / "conf.yaml"))
    assert cfg == ts.FitConfig(**KW)


def test_fit_pickles_match(fixture):
    d, _, _, _, fit = fixture
    t = trec.load_fit_pickle(str(d / "torch" / "smplh.pkl"))
    from tpubody.pipelines import reconstruct as jrec
    j = jrec.load_fit_pickle(str(d / "jax" / "smplh.pkl"))
    np.testing.assert_allclose(t.pose, fit.pose)
    for f in ("pose", "shape", "camera_translation"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                   atol=common.PARAM_ATOL, err_msg=f)
    np.testing.assert_array_equal(t.camera_center, j.camera_center)
    assert t.camera_fx == j.camera_fx
    with open(d / "torch" / "pre_smplh.pkl", "rb") as f:
        pt = pickle.load(f)
    with open(d / "jax" / "pre_smplh.pkl", "rb") as f:
        pj = pickle.load(f)
    assert set(pt) == set(pj)
    np.testing.assert_allclose(pt["loss"], pj["loss"],
                               rtol=common.LOSS_RTOL)
    for key in set(pt) - {"loss"}:
        np.testing.assert_allclose(np.asarray(pt[key], np.float64),
                                   np.asarray(pj[key], np.float64),
                                   atol=common.PARAM_ATOL, err_msg=key)


def test_mesh_and_overlay_match(fixture):
    d, _, _, _, _ = fixture
    vt, ft = tmeshio.read_obj(str(d / "torch" / "smplh.obj"))
    from tpubody.mesh import meshio as jmeshio
    vj, fj = jmeshio.read_obj(str(d / "jax" / "smplh.obj"))
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, atol=1e-3)
    a = tops.read_image(str(d / "torch" / "smplh2rgb_rend.png"))
    from tpubody.image import ops as jops
    b = jops.read_image(str(d / "jax" / "smplh2rgb_rend.png"))
    assert a.shape == b.shape == (256, 256, 3)
    near = np.abs(a.astype(int) - b.astype(int)).max(axis=-1) <= 2
    assert near.mean() >= 0.99, near.mean()


def test_image_io_matches(tmp_path):
    img = np.random.default_rng(1).uniform(0, 1, (16, 24, 3))
    tops.write_image(str(tmp_path / "t.png"), img)
    from tpubody.image import ops as jops
    jops.write_image(str(tmp_path / "j.png"), img)
    np.testing.assert_array_equal(tops.read_image(str(tmp_path / "t.png")),
                                  jops.read_image(str(tmp_path / "j.png")))
    with pytest.raises(FileNotFoundError):
        tops.read_image(str(tmp_path / "missing.png"))


def test_fit_smplh_step_serves_fits(fixture):
    _, tm, tree, kps, _ = fixture
    step, spec = serving.fit_smplh_step(tm, ts.FitConfig(**KW),
                                        dec_params=tree, device="cpu")
    assert spec["keypoints"].shape == (67, 3)
    assert spec["center"].shape == (2,)
    server = serving.InferenceServer(step, buckets=(4,), request_spec=spec,
                                     max_delay_ms=200.0, device="cpu")
    with server:
        futs = [server.submit({"keypoints": kps[i], "center": common.CENTER})
                for i in range(3)]
        served = [f.result(timeout=300) for f in futs]
    batch = np.concatenate([kps, np.zeros((1, 67, 3), np.float32)])
    direct = step.fitter.apply(
        torch.as_tensor(batch),
        torch.as_tensor(np.stack([common.CENTER] * 3
                                 + [np.zeros(2, np.float32)])))
    for i in range(3):
        for key in ("pose", "shape", "cam_t", "emb", "loss"):
            np.testing.assert_allclose(served[i][key],
                                       direct[key][i].numpy(), atol=1e-6,
                                       err_msg=key)


def test_gen_smplh_batch_and_refine(fixture, tmp_path):
    """The batch entry and the HMR-warm-started refine write the same
    artifact set per directory (HMR runs with seeded weights here, so only
    the contract is checked)."""
    d, tm, tree, _, _ = fixture
    from tpubody_torch.fit import vposer as tv
    from tpubody_torch.pipelines import refine
    items = [(str(d / "img.png"), str(d / "kp.json"), str(tmp_path / "a")),
             (str(d / "img.png"), str(d / "kp.json"), str(tmp_path / "b"))]
    fits = tgen.gen_smplh_batch(items, model=tm, config=ts.FitConfig(**KW),
                                dec_params=tv.from_flax_params(tree)[0],
                                device="cpu")
    assert len(fits) == 2
    np.testing.assert_allclose(fits[0].pose, fits[1].pose, atol=1e-5)
    for _, _, out in items:
        assert sorted(os.listdir(out)) == ARTIFACTS
    ref = refine.refine([(str(d / "img.png"), str(d / "kp.json"),
                          str(tmp_path / "r"))], model=tm,
                        config=ts.FitConfig(**KW), device="cpu")
    assert ref[0].pose.shape == (156,) and np.isfinite(ref[0].pose).all()
    assert sorted(os.listdir(tmp_path / "r")) == ARTIFACTS


@pytest.fixture(scope="module")
def hmr_pair():
    """The port's HMRPredictor with seeded weights at 64^2 on a 300-vertex
    SMPL stand-in, and tpubody's on the same weights (carried as
    tests/test_torch_serving.py carries them) and body model."""
    import jax.numpy as jnp

    from tpubody.models import hmr as jhmr
    from tpubody.models import params as jparams
    from tpubody.pipelines import hmr_infer as jinfer
    from tpubody_torch.models import params as tparams
    from tpubody_torch.pipelines import hmr_infer as tinfer

    tbody = tparams.load_or_synthetic("smpl", n_joints=24, n_verts=300,
                                      seed=0, warn=False)
    jbody = jparams.load_or_synthetic("smpl", n_joints=24, n_verts=300,
                                      seed=0, warn=False)
    tpred = tinfer.HMRPredictor(smpl_model=tbody, dtype=torch.float32,
                                img_size=64, device="cpu")
    reference = {k[len("backbone."):] if k.startswith("backbone.") else k:
                 v.numpy() for k, v in tpred.model.state_dict().items()
                 if not k.endswith("num_batches_tracked")}
    variables = jhmr.convert_torch_state_dict(reference,
                                              jhmr.default_mean_params())
    jpred = jinfer.HMRPredictor(smpl_model=jbody, variables=variables,
                                dtype=jnp.float32, img_size=64)
    return jpred, tpred


@pytest.mark.parametrize("model_type,use_vposer", [
    ("smplh", False), ("smpl", False), ("smplh", True)])
def test_hmr_init_from_images_matches_tpubody(hmr_pair, tmp_path,
                                              model_type, use_vposer):
    """refine's HMR warm start: keypoint_crop_params bit-equal; init_cam_t
    and init_params within the serving bar (1e-4, relative to each
    array's largest magnitude where that exceeds 1: the translation's
    depth is focal / (scale * 64) metres).  The crops are 64 px wide, so
    both packages' host resizes are the identity and HMR sees the same
    input."""
    from tpubody.pipelines import refine as jrefine
    from tpubody_torch.fit import vposer as tv
    from tpubody_torch.pipelines import refine as trefine

    jpred, tpred = hmr_pair
    rng = np.random.default_rng(12)
    paths, kps = [], []
    for i in range(2):
        img = rng.integers(0, 256, size=(96, 80, 3)).astype(np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], img)
        kp = np.concatenate([rng.uniform(20, 60, size=(67, 2)),
                             rng.integers(0, 2, size=(67, 1))], axis=1)
        # The bbox of the confident points spans 64 / 1.2 px in x.
        kp[0, :3] = (12.0, 40.0, 1.0)
        kp[1, :3] = (12.0 + 64.0 / 1.2, 44.0, 1.0)
        kp[kp[:, 2] > 0, 0] = np.clip(kp[kp[:, 2] > 0, 0], 12.0,
                                      12.0 + 64.0 / 1.2)
        kps.append(kp)
    kps = np.stack(kps)
    for k in kps:
        c_t, s_t = trefine.keypoint_crop_params(k)
        c_j, s_j = jrefine.keypoint_crop_params(k)
        np.testing.assert_array_equal(c_t, c_j)
        assert s_t == s_j and abs(s_t * 200.0 - 64.0) < 1e-9
    centers = np.array([[40.0, 48.0], [40.0, 48.0]])
    kw = dict(model_type=model_type, use_vposer=use_vposer,
              focal_length=common.FOCAL)
    enc_tree = common.encoder_tree() if use_vposer else None
    _, enc = tv.from_flax_params(enc_tree=enc_tree) if use_vposer else (
        None, None)
    cam_t, params_t = trefine.hmr_init_from_images(
        tpred, paths, kps, centers, ts.FitConfig(**kw), encoder=enc)
    cam_j, params_j = jrefine.hmr_init_from_images(
        jpred, paths, kps, centers, js.FitConfig(**kw), enc_params=enc_tree)
    assert set(params_t) == set(params_j)
    assert ("pose_embedding" in params_t) == use_vposer
    for name, got, want in [("init_cam_t", cam_t, cam_j)] + [
            (k, params_t[k], params_j[k]) for k in params_j]:
        want = np.asarray(want)
        assert got.shape == want.shape, name
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
