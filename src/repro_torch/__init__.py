"""AdapTBF on PyTorch and CUDA: the fleet engine of the ``repro`` package,
ported for an NVIDIA H100.  Plain tensor code is PyTorch; the window service
and the allocation round are hand-written CUDA kernels (``kernels/csrc``)."""
