"""Fleet-scale AdapTBF allocation: one CUDA block per OST row runs the whole
three-step round (``kernels/csrc/adaptbf_alloc.cu``)."""
