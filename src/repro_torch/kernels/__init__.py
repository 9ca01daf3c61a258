"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version (``<name>/ref.py``) and its dispatching wrapper
(``<name>/ops.py``)."""
