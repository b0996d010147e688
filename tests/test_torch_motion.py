"""tpubody_torch.io.motion against tpubody.io.motion: the readers agree on
the same files, and a file written by one package is read by the other
(numpy on both sides: exact equality)."""
import numpy as np
import pytest

from tpubody.io import motion as jmotion
from tpubody_torch.io import motion as tmotion


def _same_clip(a, b):
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.trans, b.trans)
    assert a.fps == b.fps


@pytest.mark.parametrize("width,stride", [(156, 1), (156, 2), (72, 1),
                                          (165, 3)])
def test_read_amass_matches(tmp_path, width, stride):
    rng = np.random.default_rng(width + stride)
    p = str(tmp_path / "clip.npz")
    np.savez(p, poses=rng.normal(size=(11, width)),
             trans=rng.normal(size=(11, 3)), mocap_framerate=120.0)
    got = tmotion.read_amass(p, stride=stride)
    _same_clip(got, jmotion.read_amass(p, stride=stride))
    assert got.poses.shape == (len(range(0, 11, stride)), 24, 3)
    np.testing.assert_array_equal(got.trans[0], 0.0)


def test_read_amass_defaults(tmp_path):
    p = str(tmp_path / "bare.npz")
    np.savez(p, poses=np.ones((4, 156)))
    got = tmotion.read_amass(p)
    _same_clip(got, jmotion.read_amass(p))
    assert got.fps == 60.0 and not got.trans.any()
    np.testing.assert_array_equal(got.poses[:, 22:], 0.0)


def test_smplh156_to_smpl24_matches():
    pose = np.random.default_rng(0).normal(size=(3, 156))
    np.testing.assert_array_equal(tmotion.smplh156_to_smpl24(pose),
                                  jmotion.smplh156_to_smpl24(pose))
    with pytest.raises(ValueError):
        tmotion.smplh156_to_smpl24(np.zeros((2, 10)))


@pytest.mark.parametrize("writer,reader", [(tmotion, jmotion),
                                           (jmotion, tmotion)])
def test_mixamo_round_trip_across_packages(tmp_path, writer, reader):
    poses = np.random.default_rng(1).normal(size=(15, 24, 3))
    p = str(tmp_path / "result.pkl")
    writer.save_mixamo(p, poses, fps=24.0)
    clip = reader.read_mixamo(p, stride=2)
    np.testing.assert_array_equal(clip.poses, poses[::2])
    assert clip.fps == 24.0 and not clip.trans.any()
    _same_clip(clip, writer.read_mixamo(p, stride=2))
