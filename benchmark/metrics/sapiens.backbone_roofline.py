"""sapiens.backbone_roofline: the least time the card could take for one
batch's Sapiens encoder, its operations (``sapiens_flops.encoder_flops``:
the patch embedding and 48 blocks at the published head width of 60,
16,533.95 GFLOP a frame, whatever the program pads) at the bf16 peak, over
the program's spans ``sapiens.backbone`` summed within a step
(``sapiens.backbone.span_ms``), in %.  Its bytes (the bf16 weights, the
crop read and the tokens written once) would take about 1% of that time at
the memory bandwidth: operations bound it."""
from benchmark import program_spans, roofline
from benchmark.models import sapiens_flops


def read(run):
    ms = program_spans.span_ms(run, "sapiens.backbone")
    peak = roofline.peak(run.kind, "bf16")
    if not ms or peak is None:
        return None
    seconds = run.mix["batch"] * sapiens_flops.encoder_flops(run.cfg) / peak
    return 100.0 * seconds / (ms * 1e-3)
