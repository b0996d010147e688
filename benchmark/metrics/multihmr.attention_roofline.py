"""multihmr.attention_roofline: the least time the card could take for one
batch's 24 attention halves of the DINOv2 encoder, their operations
(``dinov2_flops.attention_flops``: ``qkv``, Q K^T, A V and ``proj`` over
4,097 tokens, 103.12 GFLOP a block and frame) at the bf16 peak, over the
program's spans ``multihmr.attention`` summed within a step
(``multihmr.attention.span_ms``), in %.  The spans hold the LayerScaled add
+ LayerNorm pass besides, whose bytes the bound leaves out."""
from benchmark import program_spans, roofline
from benchmark.models import dinov2_flops


def read(run):
    ms = program_spans.span_ms(run, "multihmr.attention")
    peak = roofline.peak(run.kind, "bf16")
    if not ms or peak is None:
        return None
    seconds = (run.mix["batch"] * run.cfg["depth"]
               * dinov2_flops.attention_flops(run.cfg) / peak)
    return 100.0 * seconds / (ms * 1e-3)
