"""Fused window service: all ticks of one observation window of two-phase
NRS-TBF service, one CUDA block per OST row
(``kernels/csrc/fleet_window.cu``)."""
from repro_torch.kernels.fleet_window.ops import fleet_window_serve

__all__ = ["fleet_window_serve"]
