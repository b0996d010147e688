"""Shared inputs of the fitting slice's parity tests (tests/test_torch_fit*.py,
test_torch_gen_smplh.py): the same seeded numpy data for tpubody and
tpubody_torch.

  * models: params.synthetic at 1,100 vertices in both packages;
  * VPoser: tpubody's create_decoder with seeded biases (its own biases
    are zero, which makes the zero latent, where every fit starts, a
    singular point of the 6D normalisation: both packages' gradients
    there are rounding noise of order 1e9), and a seeded encoder;
  * keypoints: seeded VPoser poses through tpubody's forward, projected
    at focal 800 about (128, 128), with 1 px noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpubody.fit import joints as jjoints
from tpubody.fit import smplify as js
from tpubody.fit import vposer as jv
from tpubody.models import params as jp
from tpubody.models import smpl as jsmpl
from tpubody_torch.models import params as tp

N_VERTS = 1100
FOCAL = 800.0
CENTER = np.array([128.0, 128.0], np.float32)
# Whole-fit bar: final loss rtol; pose, betas and camera translation atol.
LOSS_RTOL = 1e-3
PARAM_ATOL = 1e-3


def models(nj=52):
    return (jp.synthetic(n_joints=nj, n_verts=N_VERTS, seed=0),
            tp.synthetic(n_joints=nj, n_verts=N_VERTS, seed=0))


def decoder_tree(seed=1):
    _, dp = jv.create_decoder(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.array, dp)
    rng = np.random.default_rng(seed + 100)
    for name in ("fc1", "fc2", "out"):
        b = tree["params"][name]["bias"]
        tree["params"][name]["bias"] = rng.normal(
            scale=0.1, size=b.shape).astype(np.float32)
    return tree


def encoder_tree(seed=2):
    ep = jv.VPoserEncoder().init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 63)))
    return jax.tree_util.tree_map(np.array, ep)


def write_vposer_ckpt(path, dec_tree, enc_tree):
    """A reference-layout VPoser state dict (bodyprior_* names, (out, in)
    weights) written with torch.save."""
    sd = {}
    for ours, ref in (("fc1", "bodyprior_dec_fc1"),
                      ("fc2", "bodyprior_dec_fc2"),
                      ("out", "bodyprior_dec_out")):
        p = dec_tree["params"][ours]
        sd[ref + ".weight"] = torch.as_tensor(p["kernel"].T.copy())
        sd[ref + ".bias"] = torch.as_tensor(p["bias"])
    for ours in ("fc1", "fc2", "mu", "logvar"):
        p = enc_tree["params"][ours]
        sd[f"bodyprior_enc_{ours}.weight"] = torch.as_tensor(
            p["kernel"].T.copy())
        sd[f"bodyprior_enc_{ours}.bias"] = torch.as_tensor(p["bias"])
    for ours in ("bn1", "bn2"):
        p, s = enc_tree["params"][ours], enc_tree["batch_stats"][ours]
        ref = f"bodyprior_enc_{ours}"
        sd[ref + ".weight"] = torch.as_tensor(p["scale"])
        sd[ref + ".bias"] = torch.as_tensor(p["bias"])
        sd[ref + ".running_mean"] = torch.as_tensor(s["mean"])
        sd[ref + ".running_var"] = torch.as_tensor(s["var"])
    torch.save(sd, path)
    return sd


def keypoints(jm, dec_tree, n=3, seeds=(1, 2, 3), orients=None,
              cam_t=(0.0, 0.0, 5.0), drift=0.0):
    """(n, 67, 3) keypoints of seeded poses (lane i: seeds[i]); ``drift``
    > 0 makes a clip: one pose whose orientation turns by ``drift`` a
    frame."""
    dec = jv.VPoserDecoder()
    dp = jax.tree_util.tree_map(jnp.asarray, dec_tree)
    out = []
    for i in range(n):
        r = np.random.default_rng(seeds[0] if drift else seeds[i])
        z = jnp.asarray(r.normal(scale=0.4, size=(32,)), jnp.float32)
        body = jv.decode_to_axis_angle(dec, dp, z[None])[0]
        orient = np.array([0.0, 0.1, 0.0] if orients is None
                          else orients[i], np.float32) + i * drift
        pose = jnp.concatenate([jnp.asarray(orient), body,
                                jnp.zeros(90)]).reshape(52, 3)
        beta = jnp.asarray(r.normal(scale=0.3, size=10), jnp.float32)
        st = jsmpl.forward(jm, pose, beta)
        j3 = jjoints.openpose_joints(st.verts, st.joints_posed)
        proj = np.asarray(js._project(j3, jnp.asarray(cam_t), FOCAL,
                                      jnp.asarray(CENTER)))
        proj = proj + np.random.default_rng(100 + i).normal(
            scale=1.0, size=proj.shape)
        out.append(np.concatenate([proj, np.ones((67, 1))], axis=1))
    return np.stack(out).astype(np.float32)


def hold_fits(j, t, loss_rtol=LOSS_RTOL, atol=PARAM_ATOL):
    """tpubody's and the port's fit outputs (FitOutput or FitBatchOutput)
    under the whole-fit bar."""
    np.testing.assert_allclose(np.asarray(t.loss), np.asarray(j.loss),
                               rtol=loss_rtol)
    for f in ("pose", "shape", "camera_translation", "pose_embedding"):
        np.testing.assert_allclose(np.asarray(getattr(t, f)),
                                   np.asarray(getattr(j, f)), atol=atol,
                                   err_msg=f)
