"""Shared inputs of the requantize tests (tests/test_torch_hmr_quant.py on
the CPU, tests/test_torch_int8_requant.py on the card): one convolution's
int32 sums with the parameters of its epilogue, and the int8 backbone as
the eager chain of tpubody_torch.models.hmr_quant._qconv.

A case lands values on the exact .5 ties of ``y / s`` and beyond +-127:
the even channels have ``x_scale * w_scale = 0.125``, biases and
residuals on the quarter grid and the first consumer scale 0.25, so ``y /
0.25 = acc / 2 + an integer`` is exact and ties wherever the sum is odd;
sums run to 3000, and one in eight to the widest |sum| of the backbone
(4608 * 127^2, past 2^24, so the cast to float32 rounds).  The odd
channels have drawn scales, biases and residuals.
"""
import dataclasses

import torch

from tpubody_torch.models import hmr_quant as tq

WIDEST_SUM = 4608 * 127 ** 2
TIE_SCALE = 0.25
SCALES = (TIE_SCALE, 0.0137)


def requant_case(M, O, n_scales, with_res, device, seed=0):
    """-> (acc (M, O) int32, QConv of the epilogue, res (M, O) or None,
    consumer scales)."""
    dev = torch.device(device)
    g = torch.Generator(dev).manual_seed(seed)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=g, device=dev)

    even = torch.arange(O, device=dev) % 2 == 0
    w_scale = torch.where(even, 0.25, uniform(O) * 0.03 + 1e-3)
    b = torch.where(even, ints(-40, 40, O) / 4.0,
                    torch.randn(O, generator=g, device=dev) * 2)
    acc = torch.where(uniform(M, O) < 0.125,
                      ints(-WIDEST_SUM, WIDEST_SUM, M, O),
                      ints(-3000, 3000, M, O)).to(torch.int32)
    # A positive tie (101 / 2 = 50.5) and a code past 127 in row 0.
    acc[0, 0], acc[0, 2] = 101, 5000
    b[0] = 0.0
    res = None
    if with_res:
        res = torch.where(even, ints(-200, 200, M, O) / 4.0,
                          torch.randn(M, O, generator=g, device=dev) * 20)
        res[0, 0] = 0.25
    qc = tq.QConv(w=torch.zeros((O, 8), dtype=torch.int8, device=dev),
                  w_scale=w_scale.float(), b=b.float(),
                  x_scale=torch.tensor(0.5, device=dev), kernel=(1, 1, 8),
                  strides=(1, 1), padding=((0, 0), (0, 0)))
    scales = [torch.tensor(s, device=dev) for s in SCALES[:n_scales]]
    return acc, qc, res, scales


def eager_backbone(qparams, x, observe=None):
    """The int8 backbone as the chain of ``_qconv`` (eager torch ops),
    the float32 max-pool, and each residual add with its relu."""
    y = tq._qconv(qparams["stem"], x, True, "stem", observe)
    x = tq._max_pool(y)
    for i, stage in enumerate(qparams["blocks"]):
        for j, blk in enumerate(stage):
            name = f"l{i}_{j}"
            y = tq._qconv(blk["conv1"], x, True, name + ".c1", observe)
            y = tq._qconv(blk["conv2"], y, True, name + ".c2", observe)
            y = tq._qconv(blk["conv3"], y, False, name + ".c3", observe)
            res = (tq._qconv(blk["down"], x, False, name + ".dn", observe)
                   if "down" in blk else x)
            x = y.add_(res).relu_()
    return torch.mean(x, dim=(1, 2))


def dn_scales_apart(qparams):
    """qparams with each downsample's input scale 1.5x its c1's.
    Calibration gives both the same maximum, so the two consumers' codes
    would agree even if one read the other's."""
    blocks = [[{**blk, "down": dataclasses.replace(
                   blk["down"], x_scale=blk["conv1"].x_scale * 1.5)}
               if "down" in blk else blk for blk in stage]
              for stage in qparams["blocks"]]
    return {**qparams, "blocks": blocks}
