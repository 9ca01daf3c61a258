"""The device rule shared by the entry points and the kernel wrappers.

Entry points run on the card unless the caller asks for the CPU by name; a
kernel wrapper launches its CUDA kernel for CUDA tensors and takes its
plain PyTorch version only for CPU tensors.  No switch routes a CUDA tensor
to a plain version.
"""
from __future__ import annotations

import torch

#: the widest row the CUDA kernels take: 512 threads x 16 lanes per thread
#: (``csrc/common.cuh``: THREADS * MAX_LPT)
MAX_JOBS = 8192


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a usable GPU raises
    rather than carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use \"cuda\" or \"cpu\"")
    return dev


def is_cuda(tensor: torch.Tensor) -> bool:
    return tensor.device.type == "cuda"


def route(*tensors: torch.Tensor) -> bool:
    """True when the kernel must launch (every tensor on one CUDA device),
    False for the plain version (every tensor on the CPU); raises on a mix
    or any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devices))}")
    if is_cuda(tensors[0]):
        return True
    if tensors[0].device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device "
                     f"{tensors[0].device}")


def check_f32(name: str, tensor: torch.Tensor, shape) -> None:
    """Raise unless ``tensor`` is a contiguous float32 tensor of ``shape``:
    what a kernel's C interface takes."""
    if tensor.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
