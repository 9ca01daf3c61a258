"""The device rule shared by the entry points and the kernel wrappers.

Entry points run on the card unless the caller asks for the CPU by name; a
kernel wrapper launches its CUDA kernel for CUDA tensors and takes its
plain PyTorch version only for CPU tensors.  No switch routes a CUDA tensor
to a plain version.
"""
from __future__ import annotations

import torch

#: the widest row one warp takes, a lane a job (``csrc/common.cuh``: WARP_J)
WARP_JOBS = 32
#: the widest row one thread block takes: 512 threads x 16 lanes per thread
#: (``csrc/common.cuh``: THREADS * MAX_LPT)
BLOCK_JOBS = 8192
#: the widest row the fleet kernels take: a cluster of 8 blocks, the
#: portable cluster size (``csrc/common.cuh``: MAX_ROW_J)
MAX_JOBS = 8 * BLOCK_JOBS


def row_layout(n_jobs: int) -> str:
    """What the fleet kernels (B1, B2, B3) run a row of ``n_jobs`` on:
    ``"warp"`` up to ``WARP_JOBS`` (one warp a row, several rows a block),
    ``"block"`` up to ``BLOCK_JOBS``, else ``"cluster"``
    (``csrc/common.cuh::row_layout`` is the same rule).  Raises
    ``ValueError`` past ``MAX_JOBS``."""
    if cluster_size(n_jobs) > 1:
        return "cluster"
    return "warp" if n_jobs <= WARP_JOBS else "block"


def cluster_size(n_jobs: int) -> int:
    """Thread blocks the fleet kernels run a row of ``n_jobs`` on: 1 up to
    ``BLOCK_JOBS``, else the fewest of 2, 4 and 8 with ``c * BLOCK_JOBS >=
    n_jobs`` (one thread-block cluster a row; ``csrc/common.cuh::
    cluster_blocks`` is the same rule).  Raises ``ValueError`` past
    ``MAX_JOBS``."""
    if n_jobs > MAX_JOBS:
        raise ValueError(f"the fleet kernels take at most {MAX_JOBS} jobs per "
                         f"row (a cluster of 8 blocks of {BLOCK_JOBS}), got "
                         f"{n_jobs}")
    return next(c for c in (1, 2, 4, 8) if c * BLOCK_JOBS >= n_jobs)


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


def check_16b(rule: str, **tensors) -> None:
    """Raise unless each tensor's base is 16-byte aligned and its strides
    but the last are multiples of 16 bytes (what TMA and 16-byte copies
    read)."""
    for name, x in tensors.items():
        size = x.element_size()
        bad = [s * size for s in x.stride()[:-1] if (s * size) % 16]
        if x.data_ptr() % 16 or bad:
            raise ValueError(
                f"{rule} needs {name}'s base 16-byte aligned and its strides "
                f"multiples of 16 bytes; got base offset "
                f"{x.data_ptr() % 16} and strides (bytes) "
                f"{[s * size for s in x.stride()]}")


def check_rates(rates: torch.Tensor, n_rows: int, n_jobs: int):
    """Raise unless ``rates`` is what the fleet kernels read: float32
    ``[W, O, J]`` of one fleet of ``n_rows`` rows, or ``[F, W, O, J]`` of
    ``F`` fleets of ``O`` rows each (``F * O == n_rows``), each fleet's
    ``[W, O, J]`` contiguous and the fleet axis of any stride that is a
    multiple of J (0: one trace shared by every fleet, as ``expand``
    gives it).  Returns (W, O, the fleet stride in rows of J).  Reads
    shapes and strides only (no views: this runs once a launch)."""
    if rates.dtype != torch.float32:
        raise TypeError(f"rates must be float32, got {rates.dtype}")
    shape, strides = tuple(rates.shape), rates.stride()
    if len(shape) not in (3, 4):
        raise ValueError("rates must be [W, O, J] or [F, W, O, J], got "
                         f"shape {shape}")
    n_fleets = shape[0] if len(shape) == 4 else 1
    n_ticks, rows_per_fleet, j = shape[-3:]
    if j != n_jobs or n_fleets * rows_per_fleet != n_rows:
        raise ValueError(f"rates of shape {shape} do not cover {n_rows} rows "
                         f"of {n_jobs} jobs")
    want = 1              # each fleet's [W, O, J] contiguous (or empty)
    for size, stride in zip(shape[:-4:-1], strides[:-4:-1]):
        if size != 1 and stride != want and 0 not in shape:
            raise ValueError("rates must be contiguous within a fleet; got "
                             f"strides {strides}")
        want *= size
    stride = strides[0] if n_fleets > 1 else 0
    if stride < 0 or stride % n_jobs or stride // n_jobs >= 2**31:
        raise ValueError("the fleet axis of rates must have a stride that is "
                         f"a non-negative multiple of J; got strides {strides}")
    return n_ticks, rows_per_fleet, stride // n_jobs
