"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``<name>/ref.py``) and its op (``<name>/ops.py``).
The CUDA sources live in ``repro_torch/csrc``."""
