"""The staged-fit objective (fit.smplify._make_body_loss) against
tpubody's, value and gradient at seeded parameters, every stage's weights.

Cases: SMPLH with VPoser and 12 PCA hand components (and the temporal
anchor), SMPLH with the GMM body prior, 24-joint SMPL, SMPL-X with face
landmarks, jaw and expression, and SMPLH with the sphere and the mesh
interpenetration terms.  Value rtol 1e-5; gradient within 1e-4 of the
largest |g| (fp32, the same math in another summation order).  Models
are params.synthetic at 1,100 vertices in both packages; the decoder is
tpubody's create_decoder with seeded biases, carried across by
from_flax_params (create_decoder's biases are zero, which makes the zero
latent, the fit's start, a singular point of the 6D normalisation).

Also: the port's gradient is that of the sum of the lanes' losses, which
is right only while no op mixes lanes; one lane's gradient must not move
when another lane's input changes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.fit import smplify as js
from tpubody.fit import vposer as jv
from tpubody.models import params as jp
from tpubody_torch.fit import smplify as ts
from tpubody_torch.fit import vposer as tv
from tpubody_torch.models import params as tp

torch.set_num_threads(1)

RTOL = 1e-5
GRAD_REL = 1e-4
N_VERTS = 1100
FOCAL = 800.0
CENTER = np.array([128.0, 128.0], np.float32)


def decoder_trees(seed=1):
    """tpubody's seeded decoder with seeded biases (numpy tree)."""
    _, dp = jv.create_decoder(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.array, dp)
    rng = np.random.default_rng(seed + 100)
    for name in ("fc1", "fc2", "out"):
        b = tree["params"][name]["bias"]
        tree["params"][name]["bias"] = rng.normal(
            scale=0.1, size=b.shape).astype(np.float32)
    return tree


def with_pca_hands(jm, tm, seed=5):
    rng = np.random.default_rng(seed)
    comps = [rng.normal(scale=0.1, size=(45, 45)).astype(np.float32)
             for _ in range(2)]
    means = [rng.normal(scale=0.1, size=45).astype(np.float32)
             for _ in range(2)]
    jm = dataclasses.replace(
        jm, hands_components_l=jnp.asarray(comps[0]),
        hands_components_r=jnp.asarray(comps[1]),
        hands_mean_l=jnp.asarray(means[0]),
        hands_mean_r=jnp.asarray(means[1]))
    tm = dataclasses.replace(
        tm, cache={}, hands_components_l=torch.as_tensor(comps[0]),
        hands_components_r=torch.as_tensor(comps[1]),
        hands_mean_l=torch.as_tensor(means[0]),
        hands_mean_r=torch.as_tensor(means[1]))
    return jm, tm


CASES = {
    "smplh_vposer_pca_anchor": (52, dict(temporal_weight=2.0), True),
    "smplh_gmm": (52, dict(use_vposer=False, body_prior_type="gmm"), False),
    "smpl_vposer": (24, dict(model_type="smpl"), False),
    "smplx_face": (55, dict(model_type="smplx", use_face=True), False),
    "smplh_sphere": (52, dict(interpenetration=True, coll_n_samples=256),
                     False),
    "smplh_mesh": (52, dict(interpenetration=True, coll_mode="mesh",
                            coll_n_samples=256, coll_n_faces=512), False),
}


def build(nj, kw, pca):
    jm = jp.synthetic(n_joints=nj, n_verts=N_VERTS, seed=0)
    tm = tp.synthetic(n_joints=nj, n_verts=N_VERTS, seed=0)
    if pca:
        jm, tm = with_pca_hands(jm, tm)
    tree = decoder_trees()
    dec = jv.VPoserDecoder()
    dp = jax.tree_util.tree_map(jnp.asarray, tree)
    tdec, _ = tv.from_flax_params(tree)
    jcfg = js.FitConfig(focal_length=FOCAL, **kw)
    tcfg = ts.FitConfig(focal_length=FOCAL, **kw)
    famj = js._setup_family(jm, jcfg)
    famt = ts._setup_family(tm, tcfg)
    hbj, hand_dim = js._setup_hand_bases(jm, jcfg)
    hbt, hand_dim_t = ts._setup_hand_bases(tm, tcfg)
    assert hand_dim == hand_dim_t
    gj = js._setup_gmm(jcfg, famj.body_dim)
    gt = ts._setup_gmm(tcfg, famt.body_dim)
    lj = js._make_body_loss(famj, dec, dp, jcfg, FOCAL, hbj, gj,
                            famj.coll_fn)
    lt = ts._make_body_loss(famt, tdec, tcfg, FOCAL, hbt, gt, famt.coll_fn)
    return jcfg, tcfg, famj, famt, hand_dim, lj, lt


def params_for(cfg, fam, hand_dim, nj, n, seed):
    rng = np.random.default_rng(seed)
    p = {"global_orient": rng.normal(scale=0.3, size=(n, 3)),
         "betas": rng.normal(scale=0.5, size=(n, 10)),
         "cam_t": np.array([[0.05, -0.1, 5.0]] * n)
         + rng.normal(scale=0.05, size=(n, 3))}
    if cfg.use_vposer:
        p["pose_embedding"] = rng.normal(scale=0.5, size=(n, 32))
    else:
        p["body_pose"] = rng.normal(scale=0.3, size=(n, fam.body_dim))
    if nj in (52, 55):
        p["lhand"] = rng.normal(scale=0.3, size=(n, hand_dim))
        p["rhand"] = rng.normal(scale=0.3, size=(n, hand_dim))
    if nj == 55:
        p["jaw"] = rng.normal(scale=0.1, size=(n, 3))
        p["expression"] = rng.normal(scale=0.5, size=(n, fam.n_expr))
    return {k: v.astype(np.float32) for k, v in p.items()}


def keypoints_for(fam, n, seed):
    rng = np.random.default_rng(seed)
    k = int(fam.jw.shape[0])
    xy = rng.uniform(60.0, 200.0, size=(n, k, 2))
    conf = rng.uniform(0.3, 1.0, size=(n, k, 1))
    return np.concatenate([xy, conf], axis=-1).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_objective_matches(case):
    nj, kw, pca = CASES[case]
    jcfg, tcfg, famj, famt, hand_dim, lj, lt = build(nj, kw, pca)
    n = 2
    p = params_for(tcfg, famt, hand_dim, nj, n, seed=3)
    kps = keypoints_for(famt, n, seed=4)
    pose_key = "pose_embedding" if tcfg.use_vposer else "body_pose"
    anchor_np = None
    if tcfg.temporal_weight > 0:
        rng = np.random.default_rng(6)
        anchor_np = (np.array([2.0, 0.5], np.float32),
                     rng.normal(size=p[pose_key].shape).astype(np.float32),
                     rng.normal(scale=0.2, size=(n, 3)).astype(np.float32))
    wsj = js._stage_weights(jcfg)
    wst = ts.stage_weight_dicts(tcfg)

    @jax.jit
    def jax_vg(q, w, gt2d, conf, center, anchor):
        a = None if anchor is None else (*anchor, pose_key)
        return jax.value_and_grad(
            lambda q: lj(q, w, gt2d, conf, center, a))(q)

    for s in range(len(wst)):
        pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        anchor_t = None if anchor_np is None else (
            *(torch.as_tensor(a) for a in anchor_np), pose_key)
        vt = lt(pt, wst[s], torch.as_tensor(kps[..., :2]),
                torch.as_tensor(kps[..., 2]),
                torch.as_tensor(np.tile(CENTER, (n, 1))), anchor_t)
        gt = dict(zip(pt, torch.autograd.grad(vt.sum(), list(pt.values()))))
        for i in range(n):
            w = {k: jnp.asarray(v[s]) for k, v in wsj.items()}
            anchor_j = None if anchor_np is None else tuple(
                jnp.asarray(a[i]) for a in anchor_np)
            vj, gj = jax_vg({k: jnp.asarray(v[i]) for k, v in p.items()}, w,
                            jnp.asarray(kps[i, :, :2]),
                            jnp.asarray(kps[i, :, 2]), jnp.asarray(CENTER),
                            anchor_j)
            np.testing.assert_allclose(float(vt[i].detach()), float(vj),
                                       rtol=RTOL)
            gmax = max(float(jnp.abs(g).max()) for g in gj.values())
            for k in p:
                err = np.abs(np.asarray(gj[k]) - gt[k][i].numpy()).max()
                assert err <= GRAD_REL * gmax, (s, i, k, err, gmax)


def test_lanes_do_not_mix():
    """Lane 0's loss and gradient are bit-equal whatever lane 1 holds."""
    tm = tp.synthetic(n_joints=52, n_verts=N_VERTS, seed=0)
    tdec, _ = tv.from_flax_params(decoder_trees())
    cfg = ts.FitConfig(focal_length=FOCAL, interpenetration=True,
                       coll_n_samples=256)
    fam = ts._setup_family(tm, cfg)
    hb, hand_dim = ts._setup_hand_bases(tm, cfg)
    loss = ts._make_body_loss(fam, tdec, cfg, FOCAL, hb, None, fam.coll_fn)
    w = ts.stage_weight_dicts(cfg)[4]
    kps = keypoints_for(fam, 2, seed=7)
    center = torch.as_tensor(np.tile(CENTER, (2, 1)))
    out = []
    for seed in (8, 9):
        p = params_for(cfg, fam, hand_dim, 52, 2, seed=3)
        p1 = params_for(cfg, fam, hand_dim, 52, 2, seed=seed)
        k = kps.copy()
        k[1] = keypoints_for(fam, 2, seed=seed)[1]
        pt = {key: torch.tensor(np.stack([p[key][0], p1[key][1]]),
                                requires_grad=True) for key in p}
        v = loss(pt, w, torch.as_tensor(k[..., :2]),
                 torch.as_tensor(k[..., 2]), center)
        g = torch.autograd.grad(v.sum(), list(pt.values()))
        out.append((v.detach(), g))
    assert torch.equal(out[0][0][0], out[1][0][0])
    assert not torch.equal(out[0][0][1], out[1][0][1])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a[0], b[0])
