"""hmr_quant.quantize.span_ms: the int8 backbone's input quantization with the
im2col, over its 53 convolutions.  The program's own span
``hmr_quant.quantize``, by its CUDA events, summed within a step; the median
over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr_quant.quantize")
