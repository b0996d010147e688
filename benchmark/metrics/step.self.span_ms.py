"""step.self.span_ms: the part of the program's ``step`` span on the device
that none of its child spans (the copy in, the backbone, the IEF head, the
LBS prologue and kernel) covers: the step's self time, by the spans' CUDA
events; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.self_ms(run)
