"""tpubody_torch.pipelines.demo against tpubody.pipelines.demo on the CPU.

``make_fixture`` at 128^2 (the 1500-vertex humanoid, tests/test_demo.py's
size) writes tpubody's layout: the same six files, which both packages'
``load_test_dir`` read alike.  Against tpubody's own fixture of the same
arguments: the fit pickle's camera within 1e-5 (it is derived from each
package's float32 forward), the keypoints within 1e-3 px, the silhouette
mask equal on at least 99.5% of the pixels and the photo within 2/255 on
as many (each package's fragment rasterizer decides edge pixels in its own
float32 order).  ``run_demo`` runs whole on the CPU at 128^2 with a 2-frame
animation: every artefact exists and loads."""
import json
import os

import numpy as np
import pytest
import torch

from tpubody.pipelines import demo as jdemo
from tpubody.pipelines import reconstruct as JR
from tpubody_torch.pipelines import demo as tdemo
from tpubody_torch.pipelines import reconstruct as TR

torch.set_num_threads(1)

SIZE = 128
VERTS = 1500
FILES = ("front_rgb.png", "back_rgb.png", "mask.png", "0_keypoints.json",
         "smplh.pkl", "conf.yaml")
AGREE = 0.995


def test_demo_pose_and_betas_equal_tpubodys():
    np.testing.assert_array_equal(tdemo.DEMO_BETAS, jdemo.DEMO_BETAS)
    for seed in (0, 3):
        np.testing.assert_array_equal(tdemo.demo_pose(52, seed),
                                      jdemo.demo_pose(52, seed))


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    t_dir = str(tmp_path_factory.mktemp("port"))
    j_dir = str(tmp_path_factory.mktemp("tpubody"))
    models = tdemo.make_fixture(t_dir, size=SIZE, verts=VERTS, device="cpu")
    jdemo.make_fixture(j_dir, size=SIZE, verts=VERTS)
    return t_dir, j_dir, models


def test_make_fixture_writes_tpubodys_layout(fixtures):
    t_dir, j_dir, (smplh, smpl) = fixtures
    assert sorted(os.listdir(t_dir)) == sorted(FILES) \
        == sorted(os.listdir(j_dir))
    assert smplh.num_joints == 52 and smpl.num_joints == 24
    assert smplh.device.type == "cpu"
    front, back, mask, fit = TR.load_test_dir(t_dir)
    assert front.shape == (SIZE, SIZE, 3) and mask.shape == (SIZE, SIZE)
    assert 200 < (mask > 0).sum() < SIZE * SIZE * 0.9
    np.testing.assert_array_equal(back, front[:, ::-1])
    jfront, jback, jmask, jfit = JR.load_test_dir(t_dir)
    for a, b in zip((jfront, jback, jmask) + tuple(jfit),
                    (front, back, mask) + tuple(fit)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    from tpubody_torch.pipelines import gen_smplh
    cfg = gen_smplh.load_config(os.path.join(t_dir, "conf.yaml"))
    assert cfg.focal_length == pytest.approx(5000.0 * SIZE / 1024.0)


def test_make_fixture_agrees_with_tpubodys(fixtures):
    t_dir, j_dir, _ = fixtures
    tf, tb, tm, tfit = TR.load_test_dir(t_dir)
    jf, jb, jm, jfit = JR.load_test_dir(j_dir)
    for a, b in zip(tfit, jfit):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(tfit.pose, jfit.pose)
    assert (tm == jm).mean() >= AGREE
    assert (np.abs(tf.astype(int) - jf.astype(int)).max(-1) <= 2).mean() \
        >= AGREE

    def kps(d):
        with open(os.path.join(d, "0_keypoints.json")) as f:
            p = json.load(f)["people"][0]
        return np.concatenate([np.asarray(p[k]) for k in (
            "pose_keypoints_2d", "hand_left_keypoints_2d",
            "hand_right_keypoints_2d")])

    np.testing.assert_allclose(kps(t_dir), kps(j_dir), atol=1e-3)


def test_run_demo_on_the_cpu(tmp_path, capfd):
    from tpubody_torch.mesh import gltf, rigging

    out = str(tmp_path / "demo")
    arts = tdemo.run_demo(out, size=SIZE, verts=VERTS, animate_frames=2,
                          device="cpu")
    for name in FILES + ("replace_hands_recover.pkl", "out.ply",
                         "avatar.glb", "demo.mp4"):
        assert os.path.exists(arts[name]), name
    assert os.path.getsize(arts["demo.mp4"]) > 0
    avatar = rigging.load_avatar(arts["replace_hands_recover.pkl"])
    assert np.isfinite(avatar.v_template).all()
    assert avatar.weights.shape[1] == 24
    g, _ = gltf.read_glb(arts["avatar.glb"])
    assert len(g["skins"][0]["joints"]) == 24
    # the hand graft took place at this size
    assert "hand replacement skipped" not in capfd.readouterr().err


def test_run_demo_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tdemo.run_demo(str(tmp_path / "d"), size=64, verts=1100)
    assert not os.path.exists(tmp_path / "d")
