"""step.h2d.span_ms: ``HMRSMPLStep``'s own copy of one batch of host images to
the card.  The program's own span ``step.h2d``, by its CUDA events, summed
within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "step.h2d")
