"""The seeded batches of the ``offline_batches`` mix."""
import numpy as np
import pytest

from benchmark import generate, harness, seeding

SEED = 2 ** 33 + 17          # more than 32 signed bits hold


@pytest.fixture
def mix():
    m = harness.mix_of("offline_batches")
    m["batch"] = 4
    return m


def test_same_seed_same_batches(mix):
    a = generate.host_batches(mix, 32, SEED, "cpu")
    b = generate.host_batches(mix, 32, SEED, "cpu")
    assert len(a) == mix["distinct_batches"] == 2
    for x, y in zip(a, b):
        assert x.shape == (4, 32, 32, 3) and x.dtype == np.float32
        assert np.array_equal(x, y)


def test_seeds_and_batches_differ(mix):
    a = generate.host_batches(mix, 32, SEED, "cpu")
    b = generate.host_batches(mix, 32, SEED + 1, "cpu")
    assert not np.allclose(a[0], b[0])
    assert not np.allclose(a[0], a[1])


def test_frames_differ_in_colour_and_contrast(mix):
    x = generate.host_batches(mix, 64, SEED, "cpu")[0].astype(np.float64)
    means = x.mean(axis=(1, 2))                        # (frames, channels)
    assert np.all(np.isfinite(x))
    assert means.std(axis=0).min() > 0.1               # colour offsets
    assert np.ptp(x.std(axis=(1, 2, 3))) > 0.05        # contrast


def test_streams_and_seed_range():
    assert seeding.stream_seed(5, "a") != seeding.stream_seed(5, "b")
    assert seeding.stream_seed(2 ** 63 - 1, "a") < 2 ** 63
    with pytest.raises(ValueError):
        seeding.stream_seed(-1, "a")


def test_checked_batches_come_from_the_seed(mix):
    chosen = harness.checked_batches(SEED, mix)
    assert chosen[0] == 0 and len(chosen) == 1 + mix["checked_batches"]
    assert chosen == harness.checked_batches(SEED, mix)
    assert chosen != harness.checked_batches(SEED + 1, mix)
