"""The kernel library's launch seam, tpubody_torch.native: the tensor
contract every kernel wrapper holds its tensors to (``expect``) and the
launch ABI they all go through (``launch``), on the CPU.

The wrappers themselves reach both only on the card (the kernel tests'
refusal cases); here ``expect`` runs on CPU and meta tensors, and
``launch`` on a stand-in library, device context and stream.
"""
import contextlib

import pytest
import torch

from tpubody_torch import native

CPU = torch.device("cpu")
F32 = torch.float32


def _misaligned():
    return torch.zeros(17, dtype=F32)[1:]          # 4 bytes past the base


# (case, tensor, dtype asked for, aligned asked for, what the message says)
REFUSED = [
    ("device", lambda: torch.zeros(16, device="meta"), F32, False,
     "on meta, expected cpu"),
    ("dtype", lambda: torch.zeros(16, dtype=torch.float64), F32, False,
     "dtype torch.float64, expected torch.float32"),
    ("dtype_set", lambda: torch.zeros(16, dtype=torch.float16),
     (torch.bfloat16, F32), False, "expected one of"),
    ("shape", lambda: torch.zeros(8, dtype=F32), F32, False,
     "shape (8,), expected (16,)"),
    ("contiguous", lambda: torch.zeros(32, dtype=F32)[::2], F32, False,
     "is not contiguous"),
    ("aligned", _misaligned, F32, True, "is not 16-byte aligned"),
]


@pytest.mark.parametrize("case,make,dtype,aligned,says", REFUSED,
                         ids=[c[0] for c in REFUSED])
def test_expect_refuses_with_one_class(case, make, dtype, aligned, says):
    with pytest.raises(native.KernelInputError) as info:
        native.expect("acc", make(), (16,), dtype, CPU, aligned=aligned)
    assert isinstance(info.value, ValueError)
    assert isinstance(info.value, RuntimeError)
    assert str(info.value).startswith("acc ")
    assert says in str(info.value)


@pytest.mark.parametrize("dtype", [F32, (torch.bfloat16, F32)],
                         ids=["dtype", "dtype_set"])
def test_expect_takes_a_well_formed_tensor(dtype):
    t = torch.zeros(4, 16, dtype=F32)
    native.expect("x", t, (4, 16), dtype, CPU, aligned=True)
    native.expect("x", t, torch.Size([4, 16]), dtype, CPU)
    # alignment is asked for, not implied: a misaligned view passes without
    native.expect("x", _misaligned(), (16,), dtype, CPU)


class _Library:
    """A stand-in for the loaded kernel library: records each call of its
    entry point and returns the error code it is given."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def tpubody_fused_lbs(self, *args):
        self.calls.append(args)
        return self.err

    def tpubody_cuda_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_cuda(monkeypatch):
    """Point ``native.launch`` at a stand-in library, device context and
    stream; -> a function making the library with a given error code, and
    the list of devices made current."""
    current = []

    @contextlib.contextmanager
    def device(dev):
        current.append(dev)
        yield

    class Stream:
        cuda_stream = 0xC0FFEE

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setitem(native.LAUNCHES, "fused_lbs", 5)

    def make(err):
        lib = _Library(err)
        monkeypatch.setattr(native, "library", lambda: lib)
        return lib

    return make, current


@pytest.mark.parametrize("count", [1, 2])
def test_launch_appends_the_stream_and_counts(fake_cuda, count):
    make, current = fake_cuda
    lib = make(0)
    dev = torch.device("cuda", 0)
    native.launch("fused_lbs", "tpubody_fused_lbs", dev, 11, None, 7,
                  count=count)
    (args,) = lib.calls
    assert args[:3] == (11, None, 7)
    assert args[3].value == 0xC0FFEE
    assert current == [dev]
    assert native.LAUNCHES["fused_lbs"] == 5 + count


def test_launch_raises_on_a_cuda_error_and_counts_nothing(fake_cuda):
    make, _ = fake_cuda
    make(700)
    with pytest.raises(RuntimeError, match=r"fused_lbs launch: CUDA error "
                       r"700 \(an illegal memory access"):
        native.launch("fused_lbs", "tpubody_fused_lbs", torch.device("cuda"))
    assert native.LAUNCHES["fused_lbs"] == 5
