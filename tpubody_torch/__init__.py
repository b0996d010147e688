"""tpubody_torch — the PyTorch/CUDA port of ``tpubody`` for NVIDIA Hopper.

Module layout mirrors ``tpubody`` so each module's counterpart is easy to
find.  The package imports torch and numpy only (never jax, flax or
``tpubody``).  Entry points take an explicit ``device`` and default to
``"cuda"``; the CPU is used only when a caller asks for it.
"""
