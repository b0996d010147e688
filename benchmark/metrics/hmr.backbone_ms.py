"""hmr.backbone_ms: ``models/hmr.py`` ``ResNet50`` on one batch (cuDNN bf16,
channels_last), by CUDA events; the median over the traced batches."""


def read(run):
    return run.span_ms("hmr.backbone")
