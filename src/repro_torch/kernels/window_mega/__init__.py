"""Window megakernel: the whole per-window control round (gate, every
service tick, observation select, policy step) in one CUDA launch per window
(``kernels/csrc/window_mega.cu``)."""
from repro_torch.kernels.window_mega.ops import mega_window_round

__all__ = ["mega_window_round"]
