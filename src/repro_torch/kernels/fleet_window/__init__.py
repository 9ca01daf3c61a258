"""Fused window service: all ticks of one observation window of two-phase
NRS-TBF service, one CUDA block per OST row
(``kernels/csrc/fleet_window.cu``)."""
