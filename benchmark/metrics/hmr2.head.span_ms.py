"""hmr2.head.span_ms: ``models/hmr2.py`` ``HMR2Head`` on one batch (the
6-layer cross-attention decoder over the 192 encoder tokens, the readout and
6D -> rotation matrices).  The program's own span ``hmr2.head``, by its CUDA
events, summed within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr2.head")
