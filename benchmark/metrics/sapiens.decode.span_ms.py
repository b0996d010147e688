"""sapiens.decode.span_ms: ``models/sapiens.py`` ``SapiensPose.decode`` on
one batch (``pose2d.soft_argmax`` over 308 heatmaps of 256 x 192 a frame:
the softmax, its peak and its expected pixel, then the crop's offset).  The
program's own span ``sapiens.decode``, by its CUDA events; the median over
the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "sapiens.decode")
