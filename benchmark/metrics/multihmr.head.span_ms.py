"""multihmr.head.span_ms: ``models/multihmr.py`` ``HPH`` on one batch (the
context of ray-encoded tokens and embeddings, the persons' queries, the
2-layer cross-attention decoder, the offset head, the readouts and 6D ->
rotation matrices).  The program's own span ``multihmr.head``, by its CUDA
events, summed within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "multihmr.head")
