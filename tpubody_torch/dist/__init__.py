"""Frame-axis distribution: a single-process device mesh (``mesh``) and
the multi-process layer on ``torch.distributed`` (``multihost``)."""
