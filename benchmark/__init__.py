"""The benchmark of tpubody_torch, the PyTorch/CUDA port (see README.md)."""
