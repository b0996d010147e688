"""hmr_quant.epilogue.span_ms: the int8 backbone's float32 epilogues
(dequantize, bias, ReLU), residual adds, max-pool and mean.  The program's
own span ``hmr_quant.epilogue``, by its CUDA events, summed within a step;
the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr_quant.epilogue")
