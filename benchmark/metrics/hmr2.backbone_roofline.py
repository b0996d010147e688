"""hmr2.backbone_roofline: the least time the card could take for one batch's
ViT-H encoder, its operations (``vit_flops.encoder_flops``: the patch
embedding and 32 blocks, 248.01 GFLOP a frame) at the bf16 peak, over the
program's span ``hmr2.backbone`` (``hmr2.backbone.span_ms``), in %.  Its
bytes (the bf16 weights, the crop read and the tokens written once) would
take under 1% of that time at the memory bandwidth: operations bound it."""
from benchmark import program_spans, roofline
from benchmark.models import vit_flops


def read(run):
    ms = program_spans.span_ms(run, "hmr2.backbone")
    peak = roofline.peak(run.kind, "bf16")
    if not ms or peak is None:
        return None
    seconds = run.mix["batch"] * vit_flops.encoder_flops(run.cfg) / peak
    return 100.0 * seconds / (ms * 1e-3)
