"""Flash attention: the forward (prefill) and one-token decode kernels."""
