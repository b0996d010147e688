"""csrc/int8_requant.cu (tpubody_torch.models.hmr_quant.requantize on the
card) against its plain version, requantize_reference, and the int8
backbone on the card against the eager chain of _qconv.

Bar: bit-equal.  The kernel evaluates the plain version's float32
operations in its order, each correctly rounded, with a true division and
round-half-to-even; on the card the plain version is the same torch ops
as the eager chain.  The cases put values on the .5 ties of y / s and
past +-127 (tests/torch_requant_common.py).  Every test needs the card:
the kernel has no CPU mode, and the CPU tests of the plain version are in
tests/test_torch_hmr_quant.py.
"""
import numpy as np
import pytest
import torch

from tests.torch_requant_common import (dn_scales_apart, eager_backbone,
                                        requant_case)
from tpubody_torch import native
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr_quant as tq

BATCH = 512          # the benchmark's batch, at 224^2
SIZE = 224
N_CONVS = 53


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the int8_requant kernel has no CPU "
                    "mode; chip_smoke.py phase 24 runs it on the card")
    return torch.device("cuda")


@pytest.fixture
def qparams(cuda):
    calib = np.random.default_rng(0).normal(
        scale=0.5, size=(4, SIZE, SIZE, 3)).astype(np.float32)
    model = thmr.create_hmr(dtype=torch.float32, device=cuda)
    return tq.quantize_hmr(model, calib)


def _images(n, device):
    return torch.as_tensor(np.random.default_rng(1).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32), device=device)


def _backbone_launches(qparams, x, monkeypatch):
    """-> [(M, O, relu, with_res, n_scales, keep)] of each requantize of
    one backbone call, in order."""
    calls = []
    launch = tq.requantize

    def recording(acc, qc, relu, res=None, scales=(), keep=False):
        calls.append((acc.shape[0], acc.shape[1], relu, res is not None,
                      len(scales), keep))
        return launch(acc, qc, relu, res, scales, keep)

    monkeypatch.setattr(tq, "requantize", recording)
    with torch.inference_mode():
        tq._backbone_int8(qparams, x)
    monkeypatch.setattr(tq, "requantize", launch)
    return calls


def _same(acc, qc, relu, res, scales, keep):
    codes, y = tq.requantize(acc, qc, relu, res, scales, keep)
    want_codes, want_y = tq.requantize_reference(acc, qc, relu, res, scales,
                                                 keep)
    torch.cuda.synchronize()
    assert len(codes) == len(want_codes)
    return (all(torch.equal(c, w) for c, w in zip(codes, want_codes))
            and (y is None if not keep else torch.equal(y, want_y)))


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_at_the_backbone_shapes(cuda, qparams,
                                                         monkeypatch):
    """Every (M, O, consumers) launch of the 512-frame backbone (sized from
    one frame: M grows with the batch), and each at M = 1 and 17."""
    calls = _backbone_launches(qparams, _images(1, cuda), monkeypatch)
    assert len(calls) == N_CONVS
    for k, (m, O, relu, with_res, n_scales, keep) in enumerate(
            dict.fromkeys(calls)):
        for M in (m * BATCH, 1, 17):
            acc, qc, res, scales = requant_case(M, O, n_scales, with_res,
                                                cuda, seed=k)
            assert _same(acc, qc, relu, res, scales, keep), (M, O, relu,
                                                             with_res,
                                                             n_scales, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("apart", (False, True))
def test_cuda_backbone_equals_the_eager_chain(cuda, qparams, apart):
    """53 launches a call; the 53 observed codes and the pooled features
    bit-equal to the chain of _qconv on the card, also where each
    downsample's scale differs from its c1's."""
    if apart:
        qparams = dn_scales_apart(qparams)
    x = _images(8, cuda)
    got, want = [], []
    before = native.LAUNCHES["int8_requant"]
    with torch.inference_mode():
        feats = tq._backbone_int8(qparams, x,
                                  lambda n, c: got.append((n, c)))
        assert native.LAUNCHES["int8_requant"] == before + N_CONVS
        tq._backbone_int8(qparams, x)
        assert native.LAUNCHES["int8_requant"] == before + 2 * N_CONVS
        ref = eager_backbone(qparams, x, lambda n, c: want.append((n, c)))
    torch.cuda.synchronize()
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == N_CONVS
    for (name, c), (_, w) in zip(got, want):
        assert torch.equal(c, w), name
    assert torch.equal(feats, ref)


@pytest.mark.cuda
def test_cuda_requantize_refuses_what_it_does_not_take(cuda):
    acc, qc, res, scales = requant_case(64, 64, 2, True, cuda)
    with pytest.raises(RuntimeError, match="contiguous"):
        tq.requantize(acc.t(), qc, True, res, scales)
    with pytest.raises(RuntimeError, match="contiguous"):
        tq.requantize(acc, qc, False, res.t(), scales)
    with pytest.raises(RuntimeError, match="expected torch.int32"):
        tq.requantize(acc.float(), qc, True, res, scales)
    with pytest.raises(RuntimeError, match="expected torch.float32"):
        tq.requantize(acc, qc, False, res.double(), scales)
    with pytest.raises(RuntimeError, match="more than 2"):
        tq.requantize(acc, qc, True, None, scales * 2)
