"""repro_torch: the PyTorch/CUDA port of the TreeCSS system (``repro``).

It mirrors the JAX package's layout and names and imports only torch
and numpy.  Entry points run on ``torch.device("cuda")`` unless the
caller passes ``device="cpu"``; each kernel op takes ``impl="kernel"``
(a hand-written CUDA kernel, built from ``kernels/csrc`` at first use)
or ``impl="ref"`` (its plain PyTorch version).
"""
