"""hmr.backbone.span_ms: ``models/hmr.py`` ``ResNet50`` on one batch (cuDNN
bf16, channels_last).  The program's own span ``hmr.backbone``, by its CUDA
events, summed within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr.backbone")
