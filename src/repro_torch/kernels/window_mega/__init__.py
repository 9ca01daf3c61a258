"""Window megakernel: the whole per-window control round (gate, every
service tick, observation select, policy step) in one CUDA launch per window
(``kernels/csrc/window_mega.cu``)."""
