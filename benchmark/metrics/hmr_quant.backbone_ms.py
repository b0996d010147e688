"""hmr_quant.backbone_ms: ``models/hmr_quant.py``'s int8 backbone on one
batch (quantize and im2col, ``torch._int_mm``, the float32 epilogue), by
CUDA events; the median over the traced batches."""


def read(run):
    return run.span_ms("hmr_quant.backbone")
