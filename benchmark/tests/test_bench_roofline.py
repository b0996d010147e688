"""The counts of ``benchmark/roofline.py`` against numbers worked by hand."""
import json
import os

import pytest

from benchmark import roofline

HERE = os.path.dirname(os.path.abspath(__file__))


def _config(name):
    with open(os.path.join(HERE, os.pardir, "configs", name + ".json")) as f:
        return json.load(f)


def test_resnet50_multiply_adds_from_its_convolution_shapes():
    # By hand, output side x output side x C_in x C_out x k^2 a convolution.
    stem = 112 * 112 * 3 * 64 * 49
    stage1 = (56 * 56 * (64 * 64 + 64 * 64 * 9 + 64 * 256 + 64 * 256)
              + 2 * 56 * 56 * (256 * 64 + 64 * 64 * 9 + 64 * 256))
    stage2 = (56 * 56 * 256 * 128 + 28 * 28 * (128 * 128 * 9 + 128 * 512
                                               + 256 * 512)
              + 3 * 28 * 28 * (512 * 128 + 128 * 128 * 9 + 128 * 512))
    stage3 = (28 * 28 * 512 * 256 + 14 * 14 * (256 * 256 * 9 + 256 * 1024
                                               + 512 * 1024)
              + 5 * 14 * 14 * (1024 * 256 + 256 * 256 * 9 + 256 * 1024))
    stage4 = (14 * 14 * 1024 * 512 + 7 * 7 * (512 * 512 * 9 + 512 * 2048
                                             + 1024 * 2048)
              + 2 * 7 * 7 * (2048 * 512 + 512 * 512 * 9 + 512 * 2048))
    assert stem == 118_013_952
    total = stem + stage1 + stage2 + stage3 + stage4
    assert total == 4_087_136_256          # torchvision's 4.09 GMAC less fc
    assert roofline.resnet50_macs(224, (3, 4, 6, 3)) == total


def test_ief_and_lbs_counts():
    # 3 iterations x 2 x (2205 x 1024 + 1024 x 1024 + 1024 x 157)
    assert roofline.ief_flops() == 20_803_584
    k = 207 + 10 + 1
    per_frame = 2 * 6890 * (3 * k + 12 * 24 + 12)
    assert roofline.lbs_flops(1, 6890, 24, k) == per_frame == 13_146_120
    assert roofline.lbs_flops(512, 6890, 24, k) == pytest.approx(6.73e9,
                                                                  rel=1e-3)
    b = roofline.lbs_bytes(512, 6890, 24, 10, 207)
    verts_out = 512 * 6890 * 3 * 4
    bases = 6890 * 3 * 218 * 4
    assert verts_out == 42_332_160 and bases == 18_024_240
    assert b == verts_out + bases + 4 * (6890 * 24 + 512 * (218 + 24 * 12))
    assert b == pytest.approx(62.05e6, rel=1e-3)


def test_lbs_bound_is_set_by_its_bytes_on_the_h100():
    cfg = _config("hmr_r50_spin_bf16")
    kind = "NVIDIA H100 80GB HBM3"
    t = roofline.lbs_seconds(cfg, 512, kind)
    assert t == pytest.approx(62.05e6 / 3.35e12, rel=1e-3)   # 18.5 us
    assert roofline.lbs_seconds(cfg, 512, "some other card") is None


def test_model_operations_a_frame():
    cfg = _config("hmr_r50_spin_int8")
    flops = roofline.hmr_smpl_flops(cfg)
    assert flops == 2 * 4_087_136_256 + 20_803_584 + 13_146_120
    assert flops == pytest.approx(8.21e9, rel=1e-3)
    assert roofline.peak("NVIDIA H100 80GB HBM3", "int8") == 1979e12
    assert roofline.peak("NVIDIA H100 80GB HBM3", "bf16") == 989e12
