"""hmr_quant.backbone.span_ms: ``models/hmr_quant.py``'s int8 backbone on one
batch (quantize and im2col, ``torch._int_mm``, the float32 epilogue).  The
program's own span ``hmr_quant.backbone``, by its CUDA events, summed within
a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr_quant.backbone")
