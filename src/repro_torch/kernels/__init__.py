"""The port's kernels: each ``<name>/`` holds ``kernel.py`` (the wrapper
of a hand-written CUDA kernel in ``csrc/``), ``ref.py`` (its plain
PyTorch version) and ``ops.py`` (the public op that picks one)."""
