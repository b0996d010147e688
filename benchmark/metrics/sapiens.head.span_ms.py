"""sapiens.head.span_ms: ``models/sapiens.py`` ``HeatmapHead`` on one batch
(two deconvolutions to 256 x 192 and two 1 x 1 convolutions, BatchNorm
folded, ReLU, in bf16 channels-last, then the final 1 x 1 convolution to
308 float32 heatmaps).  The program's own span ``sapiens.head``, by its
CUDA events; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "sapiens.head")
