"""tpubody_torch.mesh.hands against tpubody.mesh.hands.

The mesh-level graft on tests/test_hands.py's inputs (an open tube body
with a 30-column attribute block, a thinner tube as the SMPL donor, the
wrists at x = +-1.6): both packages run the same numpy arithmetic (the
B-spline resampling and loft in float32, the cuts and sections in
float64), so the grafted points, faces and joints are held equal
(tolerance 0).  The avatar-level graft runs the SMPL forward in float32 on
each package's own side (torch ops here, XLA there); the float32 loft of
the bridge carries those last bits on, so it is held within 1e-5
(measured 1.4e-6; BASELINE.json's vertex bar is 1e-4), faces equal.  The
degrade branch (no wrist section) prints the same warning in both and
returns the avatar unchanged, and strict=True raises the same
ValueError."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tpubody.mesh import hands as JHd
from tpubody.mesh import rigging as JRig
from tpubody.models import params as jparams
from tpubody_torch.mesh import hands as THd
from tpubody_torch.mesh import rigging as TRig
from tpubody_torch.models import params as tparams

from tests.test_hands import _joints, _tube

ATOL = 1e-5


@pytest.fixture(scope="module")
def grafts():
    body, bf = _tube(radius=0.3, color=(200, 50, 50))
    smpl, sf = _tube(radius=0.25, color=(125, 125, 125))
    args = (body, bf, _joints(), smpl, sf, _joints())
    return THd.replace_hands_mesh(*args), JHd.replace_hands_mesh(*args)


def test_graft_equals_tpubodys(grafts):
    got, want = grafts
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(got.points).all()
    assert got.faces.min() >= 0 and got.faces.max() < got.points.shape[0]


def test_graft_closes_the_wrists_and_recolours_the_hands(grafts):
    from tpubody_torch.mesh import grid_mesh as TG

    got, _ = grafts
    body, bf = _tube()
    assert TG.boundary_edges(got.faces).shape[0] \
        <= 3 * TG.boundary_edges(bf).shape[0]
    hand = np.abs(got.points[:, 0]) > 1.75
    assert hand.any() and not np.any(got.points[hand, 3:6] == 125.0)
    assert not np.allclose(got.joints[20], _joints()[20])
    assert -1.9 < got.joints[20][0] < -1.0


def tube_models():
    """Both packages' SMPL stand-in whose zero-pose forward is the thinner
    tube (tests/test_hands.py's avatar-level case)."""
    smpl_pts, sfaces = _tube(radius=0.25, color=(125, 125, 125))
    sverts = smpl_pts[:, :3]
    V = sverts.shape[0]
    dist = np.linalg.norm(sverts[:, None] - _joints()[None], axis=-1)
    prox = np.exp(-dist.T / 0.05)
    raw = dict(v_template=sverts, shapedirs=np.zeros((V, 3, 10)),
               posedirs=np.zeros((V, 3, 207)),
               j_regressor=prox / prox.sum(1, keepdims=True),
               weights=np.ones((V, 24)) / 24,
               parents=tparams.SMPL_PARENTS,
               faces=np.asarray(sfaces, np.int32))
    base = jparams.synthetic(n_joints=24, n_verts=V, seed=0)
    jmodel = dataclasses.replace(base, **{
        k: (jnp.asarray(v, jnp.float32) if k not in ("parents", "faces")
            else v) for k, v in raw.items()})
    return tparams.params_from_numpy(raw, device="cpu"), jmodel


def tube_avatar(package, radius=0.3):
    body, bf = _tube(radius=radius, color=(200, 50, 50))
    return package.RiggedAvatar(
        v_template=body[:, :3], weights=body[:, 6:30], color=body[:, 3:6],
        faces=bf, joints=_joints(), parents=tparams.SMPL_PARENTS,
        or_pose=np.zeros((24, 3)), or_shape=np.zeros(10))


def test_avatar_graft_equals_tpubodys(capfd):
    tmodel, jmodel = tube_models()
    got = THd.replace_hands(tube_avatar(TRig), tmodel)
    want = JHd.replace_hands(tube_avatar(JRig), jmodel)
    err = capfd.readouterr().err
    assert "hand replacement skipped" not in err, err
    assert got.v_template.shape == want.v_template.shape
    assert got.v_template.shape[0] > tube_avatar(TRig).v_template.shape[0]
    np.testing.assert_allclose(got.v_template, want.v_template, atol=ATOL)
    np.testing.assert_allclose(got.joints, want.joints, atol=ATOL)
    np.testing.assert_allclose(got.weights, want.weights, atol=ATOL)
    np.testing.assert_allclose(got.color, want.color, atol=ATOL)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.weights.sum(1), 1.0, atol=1e-6)
    assert type(got) is TRig.RiggedAvatar


def test_degenerate_wrists_degrade_alike(capfd):
    """A body with nothing beyond the wrist planes: both packages warn the
    same and keep the avatar; strict=True raises the same error."""
    tmodel, jmodel = tube_models()
    short_t, short_j = tube_avatar(TRig), tube_avatar(JRig)
    keep = np.abs(short_t.v_template[:, 0]) < 1.0
    remap = np.cumsum(keep) - 1
    faces = remap[short_t.faces[keep[short_t.faces].all(axis=1)]]
    short_t = short_t._replace(v_template=short_t.v_template[keep],
                               weights=short_t.weights[keep],
                               color=short_t.color[keep], faces=faces)
    short_j = short_j._replace(v_template=short_t.v_template,
                               weights=short_t.weights,
                               color=short_t.color, faces=faces)
    got = THd.replace_hands(short_t, tmodel)
    err_t = capfd.readouterr().err
    want = JHd.replace_hands(short_j, jmodel)
    err_j = capfd.readouterr().err
    assert "hand replacement skipped" in err_t and err_t == err_j
    assert got is short_t and want is short_j
    with pytest.raises(ValueError) as e_t:
        THd.replace_hands(short_t, tmodel, strict=True)
    with pytest.raises(ValueError) as e_j:
        JHd.replace_hands(short_j, jmodel, strict=True)
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("n", [7, 12, 30])
def test_ring_helpers_equal_tpubodys(n):
    rng = np.random.default_rng(n)
    th = np.sort(rng.uniform(0, 2 * np.pi, n))
    ring = np.stack([np.full(n, 0.5), 0.3 * np.cos(th), 0.3 * np.sin(th)],
                    axis=1)[rng.permutation(n)]
    axis = np.array([1.0, 0.1, 0.0])
    for fn, args in (("_sort_ring", (ring, axis)),
                     ("_scale_ring", (ring, 0.8)),
                     ("_resample_ring", (ring[np.argsort(th)], 16)),
                     ("_pairwise_argmin", (ring, ring[::-1]))):
        np.testing.assert_array_equal(getattr(THd, fn)(*args),
                                      getattr(JHd, fn)(*args))
