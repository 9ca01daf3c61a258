"""Numerics shared by the plain versions and their CUDA kernels."""
from __future__ import annotations

import torch


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """[..., J] float32 -> [..., 1]: accumulated in float64 and rounded once.

    The CUDA kernels (``csrc/common.cuh::block_sum``) accumulate a row in
    double too, in another order.  Two double sums of the same float32 terms
    can differ in their last bit, and near a float32 rounding midpoint they
    then round apart, so kernel and plain version agree to a float32 ulp
    (in practice bitwise); the checks hold them to a tolerance."""
    return x.sum(dim=-1, keepdim=True, dtype=torch.float64).to(torch.float32)
