"""The fitting slice's small modules against tpubody's: fit.keypoints,
fit.priors, fit.joints, models.params.restrict_model, fit.vposer,
fit.collision and fit.mesh_collision, on the same seeded numpy inputs.

Values in fp32 are held at rtol 1e-5 / atol 1e-6 (the same math in
another summation order); host-side numpy tables (keypoint maps, GMM,
collision proxies, reduced-model rows) must be equal.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.fit import collision as jcoll
from tpubody.fit import joints as jjoints
from tpubody.fit import keypoints as jkp
from tpubody.fit import mesh_collision as jmcoll
from tpubody.fit import priors as jpriors
from tpubody.fit import vposer as jvposer
from tpubody.models import params as jparams
from tpubody.models import smpl as jsmpl
from tpubody_torch.fit import collision as tcoll
from tpubody_torch.fit import joints as tjoints
from tpubody_torch.fit import keypoints as tkp
from tpubody_torch.fit import mesh_collision as tmcoll
from tpubody_torch.fit import priors as tpriors
from tpubody_torch.fit import vposer as tvposer
from tpubody_torch.models import params as tparams
from tpubody_torch.models import smpl as tsmpl

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6
N_VERTS = 1100


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def models():
    out = {}
    for nj in (24, 52, 55):
        out[nj] = (jparams.synthetic(n_joints=nj, n_verts=N_VERTS, seed=0),
                   tparams.synthetic(n_joints=nj, n_verts=N_VERTS, seed=0))
    return out


def _posed(models, nj, n=2, seed=0):
    """n seeded poses through both packages' forward -> (jax states, torch
    state)."""
    jm, tm = models[nj]
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.3, size=(n, nj, 3)).astype(np.float32)
    beta = rng.normal(scale=0.5, size=(n, jm.num_betas)).astype(np.float32)
    js = [jsmpl.forward(jm, jnp.asarray(pose[i]), jnp.asarray(beta[i]))
          for i in range(n)]
    ts = tsmpl.forward(tm, _t(pose), _t(beta))
    return js, ts


# -- fit.keypoints ----------------------------------------------------------
def test_keypoint_maps_and_weights_equal():
    for use_hands in (True, False):
        np.testing.assert_array_equal(jkp.smplh_to_openpose(use_hands),
                                      tkp.smplh_to_openpose(use_hands))
    np.testing.assert_array_equal(jkp.smpl_to_openpose(),
                                  tkp.smpl_to_openpose())
    for args in ((True, True, True), (True, True, False), (False, False,
                                                           False)):
        np.testing.assert_array_equal(jkp.smplx_to_openpose(*args),
                                      tkp.smplx_to_openpose(*args))
        np.testing.assert_array_equal(
            jkp.joint_weights((1, 9, 12), *args),
            tkp.joint_weights((1, 9, 12), *args))


def test_openpose_json_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    body, lh, rh = (rng.uniform(0, 500, (n, 3)) for n in (25, 21, 21))
    path = str(tmp_path / "kp.json")
    tkp.write_openpose_json(path, body, lh, rh)
    assert tkp.num_people(path) == jkp.num_people(path) == 1
    for use_hands in (True, False):
        a = jkp.read_openpose_json(path, use_hands=use_hands,
                                   use_face=True)
        b = tkp.read_openpose_json(path, use_hands=use_hands,
                                   use_face=True)
        np.testing.assert_array_equal(a.keypoints, b.keypoints)
    jpath = str(tmp_path / "jkp.json")
    jkp.write_openpose_json(jpath, body, lh, rh)
    assert open(jpath).read() == open(path).read()


# -- fit.priors -------------------------------------------------------------
def test_priors_match():
    rng = np.random.default_rng(1)
    x = rng.normal(scale=50.0, size=(3, 67, 2)).astype(np.float32)
    close(jpriors.gmof(jnp.asarray(x), 100.0), tpriors.gmof(_t(x), 100.0))
    pose = rng.normal(scale=0.5, size=(3, 69)).astype(np.float32)
    close(jax.vmap(jpriors.l2_prior)(jnp.asarray(pose)),
          tpriors.l2_prior(_t(pose)))
    close(jpriors.angle_prior(jnp.asarray(pose)),
          tpriors.angle_prior(_t(pose)))
    jg = jpriors.synthetic_gmm(8, 63, seed=3)
    tg = tpriors.synthetic_gmm(8, 63, seed=3)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    close(jax.vmap(lambda p: jpriors.max_mixture_prior(p, jg))(
        jnp.asarray(pose[:, :63])),
        tpriors.max_mixture_prior(_t(pose[:, :63]), tg))


def test_load_gmm_matches(tmp_path):
    rng = np.random.default_rng(2)
    K, D = 3, 6
    a = rng.normal(size=(K, D, D))
    gmm = {"means": rng.normal(size=(K, D)),
           "covars": np.einsum("kij,klj->kil", a, a) + np.eye(D),
           "weights": np.array([0.2, 0.3, 0.5])}
    path = str(tmp_path / "gmm.pkl")
    with open(path, "wb") as f:
        pickle.dump(gmm, f)
    for x, y in zip(jpriors.load_gmm(path), tpriors.load_gmm(path)):
        close(x, y)


# -- fit.joints -------------------------------------------------------------
@pytest.mark.parametrize("nj,use_hands,use_face", [
    (52, True, False), (52, False, False), (24, True, False),
    (55, True, True)])
def test_openpose_joints_match(models, nj, use_hands, use_face):
    jm, tm = models[nj]
    np.testing.assert_array_equal(
        jjoints.extra_vertex_ids(N_VERTS, nj),
        tjoints.extra_vertex_ids(N_VERTS, nj))
    lj = jjoints.landmark_gather(jm) if use_face else None
    lt = tjoints.landmark_gather(tm) if use_face else None
    js, ts = _posed(models, nj)
    got = tjoints.openpose_joints(ts.verts, ts.joints_posed,
                                  use_hands=use_hands, lmk=lt,
                                  use_face=use_face, use_face_contour=True)
    for i, st in enumerate(js):
        want = jjoints.openpose_joints(st.verts, st.joints_posed,
                                       use_hands=use_hands, lmk=lj,
                                       use_face=use_face,
                                       use_face_contour=True)
        close(want, got[i], atol=1e-5)


# -- models.params.restrict_model -------------------------------------------
def test_restrict_model_is_exact_and_matches(models):
    jm, tm = models[52]
    ids = np.array([5, 17, 5, 900, 332, 1099, 0])
    jr, jrows = jparams.restrict_model(jm, ids)
    tr, trows = tparams.restrict_model(tm, ids)
    np.testing.assert_array_equal(jrows, trows)
    for f in ("v_template", "shapedirs", "posedirs", "weights",
              "j_regressor"):
        close(getattr(jr, f), getattr(tr, f))
    rng = np.random.default_rng(3)
    pose = _t(rng.normal(scale=0.3, size=(2, 52, 3)).astype(np.float32))
    beta = _t(rng.normal(size=(2, 10)).astype(np.float32))
    full = tsmpl.forward(tm, pose, beta)
    red = tsmpl.forward(tr, pose, beta)
    np.testing.assert_allclose(red.joints_posed, full.joints_posed,
                               atol=1e-6)
    np.testing.assert_allclose(red.verts[:, trows], full.verts[:, ids],
                               atol=1e-6)


# -- fit.vposer -------------------------------------------------------------
@pytest.fixture(scope="module")
def vposer_trees():
    dec, dp = jvposer.create_decoder(jax.random.PRNGKey(4))
    enc = jvposer.VPoserEncoder()
    ep = enc.init(jax.random.PRNGKey(5), jnp.zeros((1, 63)))
    rng = np.random.default_rng(6)
    ep = jax.tree_util.tree_map(np.asarray, ep)
    for name in ("bn1", "bn2"):     # nontrivial running statistics
        st = ep["batch_stats"][name]
        st["mean"] = rng.normal(scale=0.1, size=st["mean"].shape).astype(
            np.float32)
        st["var"] = rng.uniform(0.5, 2.0, size=st["var"].shape).astype(
            np.float32)
    return dec, jax.tree_util.tree_map(np.asarray, dp), enc, ep


def test_vposer_from_flax_params(vposer_trees):
    dec, dp, enc, ep = vposer_trees
    tdec, tenc = tvposer.from_flax_params(dp, ep)
    rng = np.random.default_rng(7)
    z = rng.normal(size=(4, 32)).astype(np.float32)
    with torch.no_grad():
        close(dec.apply(dp, jnp.asarray(z)), tdec(_t(z)), atol=1e-5)
        close(jvposer.decode_to_axis_angle(dec, dp, jnp.asarray(z)),
              tvposer.decode_to_axis_angle(tdec, _t(z)), atol=1e-5)
        pose = rng.normal(scale=0.3, size=(4, 63)).astype(np.float32)
        jmu, jscale = enc.apply(ep, jnp.asarray(pose))
        tmu, tscale = tenc(_t(pose))
    close(jmu, tmu, atol=1e-5)
    close(jscale, tscale, atol=1e-5)


def test_vposer_torch_checkpoint(tmp_path, vposer_trees):
    """A reference-layout state dict (bodyprior_* names, (out, in)
    weights) loads straight into the port's modules and equals the flax
    trees it was written from."""
    dec, dp, enc, ep = vposer_trees
    sd = {}
    for ours, ref in (("fc1", "bodyprior_dec_fc1"),
                      ("fc2", "bodyprior_dec_fc2"),
                      ("out", "bodyprior_dec_out")):
        sd[ref + ".weight"] = torch.as_tensor(dp["params"][ours]["kernel"].T)
        sd[ref + ".bias"] = torch.as_tensor(dp["params"][ours]["bias"])
    for ours in ("fc1", "fc2", "mu", "logvar"):
        p = ep["params"][ours]
        sd[f"bodyprior_enc_{ours}.weight"] = torch.as_tensor(p["kernel"].T)
        sd[f"bodyprior_enc_{ours}.bias"] = torch.as_tensor(p["bias"])
    for ours in ("bn1", "bn2"):
        p, s = ep["params"][ours], ep["batch_stats"][ours]
        ref = f"bodyprior_enc_{ours}"
        sd[ref + ".weight"] = torch.as_tensor(p["scale"])
        sd[ref + ".bias"] = torch.as_tensor(p["bias"])
        sd[ref + ".running_mean"] = torch.as_tensor(s["mean"])
        sd[ref + ".running_var"] = torch.as_tensor(s["var"])
        sd[ref + ".num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "vposer.pt")
    torch.save(sd, path)
    tdec, tenc = tvposer.load_torch_checkpoint(path)
    fdec, fenc = tvposer.from_flax_params(dp, ep)
    for a, b in ((tdec, fdec), (tenc, fenc)):
        for (k, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(x, y), k
    jd, je = jvposer.convert_torch_checkpoint(
        {k: v.numpy() for k, v in sd.items()})
    z = np.random.default_rng(8).normal(size=(2, 32)).astype(np.float32)
    with torch.no_grad():
        close(dec.apply(jd, jnp.asarray(z)), tdec(_t(z)), atol=1e-5)


def test_create_decoder_is_seeded():
    a, b = tvposer.create_decoder(3), tvposer.create_decoder(3)
    c = tvposer.create_decoder(4)
    assert torch.equal(a.fc1.weight, b.fc1.weight)
    assert not torch.equal(a.fc1.weight, c.fc1.weight)
    assert a.out.bias.abs().max() > 0     # regular at the zero latent


# -- fit.collision / fit.mesh_collision -------------------------------------
def _np_model(jm):
    return (np.asarray(jm.v_template), np.asarray(jm.weights),
            np.asarray(jm.parents))


def test_sphere_collision_matches(models):
    jm, tm = models[52]
    v, w, par = _np_model(jm)
    jp = jcoll.build_collision_proxy(v, w, par, n_samples=256)
    tp = tcoll.build_collision_proxy(v, w, par, n_samples=256)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    js, ts = _posed(models, 52, seed=9)
    got = tcoll.penetration_loss(ts.verts, tcoll.to_device(tp, "cpu"))
    for i, st in enumerate(js):
        close(jcoll.penetration_loss(st.verts, jp), got[i])


def test_mesh_collision_matches(models):
    jm, tm = models[52]
    v, w, par = _np_model(jm)
    faces = np.asarray(jm.faces)
    jp = jmcoll.build_mesh_collision(v, faces, w, par, n_faces=512,
                                     n_verts=256)
    tp = tmcoll.build_mesh_collision(v, faces, w, par, n_faces=512,
                                     n_verts=256)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    js, ts = _posed(models, 52, seed=10)
    got = tmcoll.mesh_penetration_loss(ts.verts, tp)
    depths = tmcoll.penetration_depths(ts.verts, tp)
    for i, st in enumerate(js):
        # The in-plane radius is sqrt(|v-c|^2 - sd^2) from two matmuls: its
        # fp32 cancellation moves a few of 131,072 depths (max ~0.2) by
        # up to 2e-6, hence atol 1e-5 on the depths; the loss is held at
        # the module bar.
        close(jmcoll.penetration_depths(st.verts, jp), depths[i],
              atol=1e-5)
        close(jmcoll.mesh_penetration_loss(st.verts, jp), got[i])
