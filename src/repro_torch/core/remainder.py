"""Integer token distribution with remainder accumulation (paper Eq. 21-25).

Each allocation step must hand out an *integer* number of tokens whose
masked total equals the step's budget exactly.  Fractional remainders are
carried per job across steps and windows; flooring errors are corrected
largest-remainder-first (+1 on leftover, -1 on excess).

Every step is integer or exact-integer float arithmetic, so the result is
bitwise the reference's on any device and in any reduction order
(``tests/test_torch_remainder.py``).  The CUDA allocation round
(``kernels/csrc/alloc_round.cuh``) runs the same rounds with a radix select
for the top-k membership and a 32-candidate excess descent, modelled in
``kernels/adaptbf_alloc/ref.py``.

Jobs live on the LAST axis; ``budget`` and ``k`` broadcast against
``[..., 1]`` (a scalar in the 1-D case).
"""
from __future__ import annotations

import torch

# bit width of the excess-correction round search: full take-one rounds per
# job are bounded by max(floored), and float32 only represents integers
# exactly up to 2^24, so 25 bits cover every representable excess
_P_BITS = 25


def rank_desc(key: torch.Tensor) -> torch.Tensor:
    """Dense rank along the last axis (0 = largest key), ties broken by the
    lower index: a stable descending sort.  -0.0 ties +0.0 and -inf ranks
    last."""
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    ranks = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def topk_mask(key: torch.Tensor, k) -> torch.Tensor:
    """Membership of the ``k`` largest entries of ``key`` along the last axis,
    ties broken by lower index first: ``rank_desc(key) < k``.

    The reference finds the same membership without sorting (a 32-probe
    binary search on the float32 bit pattern plus a log2(J)-probe index
    tie-break); the CUDA allocation kernel finds it by a radix select over
    the same bit map, and this sort is their independent plain version.
    All are bitwise the reference's (``tests/test_torch_remainder.py``,
    ``tests/test_torch_alloc_search.py``).

    Args:
      key: [..., J] float32; exclude entries by setting them to -inf.
      k: [..., 1]-broadcastable integer count (k <= 0 selects nothing,
        k >= J selects everything).

    Returns:
      [..., J] bool membership mask.
    """
    k = torch.as_tensor(k, device=key.device)
    return rank_desc(key.to(torch.float32)) < k


def integerize(raw: torch.Tensor, remainder: torch.Tensor, budget,
               mask: torch.Tensor, *, specialize: bool = False):
    """Floor ``raw + remainder`` over ``mask``-ed jobs and correct so that the
    masked total equals ``budget`` exactly.

    Args:
      raw:       [..., J] fractional token allocation.
      remainder: [..., J] carried remainders rho (updated only where masked).
      budget:    integral total per row ([..., 1]-broadcastable).
      mask:      [..., J] bool, jobs participating in this step.
      specialize: accepted for the reference's signature and ignored.  In
                 the reference it only skips the excess correction when no
                 row needs it, and the result is bitwise the same.

    Returns:
      (alloc, new_remainder): integer-valued float allocations summing to
      ``budget`` over the mask, and the updated remainder carry.

    The correction is multi-round in both directions.  Leftover (+1) rounds
    hand at most one token per masked job, so a delta of q * n_masked + r
    is q tokens for every masked job plus the top-r remainders.  Excess (-1)
    rounds may only take from jobs still holding a token: p full
    take-one-each rounds (p = the largest r whose cumulative take
    sum(min(r, floored)) fits the excess, by bit-descent) then a partial
    top-k round over the jobs holding more than p.  A row consumes one
    direction only, so both top-k searches share one ``topk_mask`` call.
    """
    budget = torch.as_tensor(budget, dtype=torch.float32, device=raw.device)
    zero = torch.zeros_like(raw)
    raw = torch.where(mask, raw, zero)
    x = torch.where(mask, raw + remainder, zero)
    # a job may carry a *negative* remainder (it was bumped +1 earlier,
    # Eq. 24); allocations clamp at zero and the debt persists
    floored = torch.clamp_min(torch.floor(x), 0.0)
    rem = torch.where(mask, x - floored, zero)

    # torch.round rounds half to even, as jnp.round does
    delta = torch.round(budget - floored.sum(dim=-1, keepdim=True))
    delta_i = torch.clamp(delta, -(2.0**30), 2.0**30).to(torch.int32)
    n_masked = mask.sum(dim=-1, keepdim=True, dtype=torch.int32)
    neg_inf = torch.full_like(raw, -torch.inf)
    fmask = mask.to(torch.float32)

    # leftover: q full rounds plus a partial top-k round
    d_up = torch.clamp_min(delta_i, 0)
    q = torch.div(d_up, torch.clamp_min(n_masked, 1), rounding_mode="floor")
    part = d_up - q * n_masked

    # excess: p full take-one rounds; g(r) counts the tokens r rounds remove
    # (integer-valued sums below 2^24, exact in any order)
    d_dn = torch.clamp_min(-delta, 0.0)
    mfloored = torch.where(mask, floored, zero)

    def _g(r):
        return torch.minimum(mfloored, r).sum(dim=-1, keepdim=True)

    p = torch.zeros_like(delta_i)
    for bit in range(_P_BITS - 1, -1, -1):
        cand = p | (1 << bit)
        p = torch.where(_g(cand.to(torch.float32)) <= d_dn, cand, p)
    p_f = p.to(torch.float32)
    k_dn = torch.clamp_max(d_dn - _g(p_f), 2.0**30).to(torch.int32)
    elig = mask & (floored >= p_f + 1.0)
    take_full = torch.minimum(mfloored, p_f)

    is_up = delta > 0
    sel = topk_mask(
        torch.where(is_up, torch.where(mask, rem, neg_inf),
                    torch.where(elig, rem, neg_inf)),
        torch.where(is_up, part, k_dn))
    bump_up = q.to(torch.float32) * fmask + (sel & mask).to(torch.float32)
    bump_dn = take_full + (sel & elig).to(torch.float32)

    applied = torch.where(delta > 0, bump_up,
                          torch.where(delta < 0, -bump_dn, zero))
    alloc = floored + applied
    new_remainder = torch.where(mask, rem - applied, remainder)
    return alloc, new_remainder


def passthrough(raw, remainder, budget, mask):
    """Float (non-integerizing) variant with the same signature."""
    del budget
    return torch.where(mask, raw, torch.zeros_like(raw)), remainder
