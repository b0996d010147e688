"""hmr.ief.span_ms: the IEF head on one batch (``HMR.ief``, or the int8 model's
float32 head).  The program's own span ``hmr.ief``, by its CUDA events,
summed within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr.ief")
