"""sapiens.attention_roofline: the least time the card could take for one
batch's 48 attention halves of the Sapiens encoder, their operations
(``sapiens_flops.attention_flops``: ``qkv``, Q K^T, A V and ``proj`` over
3,072 tokens at the published head width of 60, 163.07 GFLOP a block and
frame, whatever the program pads) at the bf16 peak, over the program's
spans ``sapiens.attention`` summed within a step
(``sapiens.attention.span_ms``), in %.  The spans hold the add + LayerNorm
pass besides, whose bytes the bound leaves out."""
from benchmark import program_spans, roofline
from benchmark.models import sapiens_flops


def read(run):
    ms = program_spans.span_ms(run, "sapiens.attention")
    peak = roofline.peak(run.kind, "bf16")
    if not ms or peak is None:
        return None
    seconds = (run.mix["batch"] * run.cfg["depth"]
               * sapiens_flops.attention_flops(run.cfg) / peak)
    return 100.0 * seconds / (ms * 1e-3)
