"""AdapTBF: adaptive token borrowing/lending allocation (paper Section III-C).

One observation window of the decentralized allocator, written once in
row-batched ``[O, J]`` form (one row per storage target).  Three sequential
steps over the *active* job set (jobs with demand in the window):

  1. priority-based initial allocation          (Eq. 1-2)
  2. redistribution of surplus tokens           (Eq. 3-8)
  3. re-compensation for borrowed tokens        (Eq. 9-20)

plus largest-remainder integer fairness at every distribution step
(Eq. 21-25, ``remainder.py``).  Every reduction is along the job axis, so no
operation mixes OSTs.  This is the plain version of the allocation kernel
(``kernels/csrc/adaptbf_alloc.cu``), op for op.

Deviations from the paper (DESIGN.md section 2):
  * u_x uses max(alpha_prev, 1) in the denominator and is capped at u_max.
  * the reclaim amount is clamped to alpha_RD so allocations stay
    non-negative; outstanding debt is repaid over later windows.
  * total reclaim is capped at what the active lenders are still owed, and
    each lender's compensation at its own record (excess re-shared among
    lenders with headroom).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.remainder import integerize, passthrough
from repro_torch.core.state import AllocatorState
from repro_torch.kernels.numerics import row_sum

_EPS = 1e-12


def alloc_rows(demand, nodes, record, remainder, alloc_prev, capacity,
               u_max: float, integer_tokens: bool = True):
    """The three-step window allocation on ``[O, J]`` rows.

    ``capacity`` is ``[O, 1]``.  Returns (alloc, new_record, new_remainder).
    """
    dist = integerize if integer_tokens else passthrough
    zero = torch.zeros_like(demand)
    active = demand > 0
    any_active = active.any(dim=-1, keepdim=True)

    # step 1: priority-based initial allocation (Eq. 1-2)
    n_act = torch.where(active, nodes, zero)
    p = n_act / torch.clamp_min(row_sum(n_act), _EPS)
    budget1 = torch.where(any_active, capacity, torch.zeros_like(capacity))
    alpha1, rem = dist(budget1 * p, remainder, budget1, active)

    # step 2: surplus redistribution (Eq. 3-8)
    u = torch.clamp_max(demand / torch.clamp_min(alloc_prev, 1.0), u_max)
    u = torch.where(active, u, zero)
    surplus = torch.where(active, torch.clamp_min(alpha1 - demand, 0.0), zero)
    t_s = row_sum(surplus)
    df = torch.where(u > 1.0, u + u * p, u * p)
    df = torch.where(active, df, zero)
    share = df / torch.clamp_min(row_sum(df), _EPS)
    add_rd, rem = dist(share * t_s, rem, t_s, active)
    alpha_rd = alpha1 - surplus + add_rd
    r_rd = record + surplus - add_rd

    # step 3: re-compensation (Eq. 9-20)
    j_plus = active & (record > 0) & (r_rd > 0)
    j_minus = active & (record < 0) & (r_rd < 0)
    u_future = demand / torch.clamp_min(alpha_rd, 1.0)
    c_terms = p * (torch.clamp_min(u, 1.0)
                   + torch.clamp_min(1.0 - u_future, 0.0)) / 2.0
    c = row_sum(torch.where(j_plus, c_terms, zero))
    reclaim = torch.minimum(record.abs(), (c * alpha_rd).abs())
    reclaim = torch.minimum(reclaim, alpha_rd)
    reclaim = torch.where(j_minus, reclaim, zero)
    # total reclaim capped at what active lenders are owed; per-lender
    # compensation capped at its record (DESIGN.md deviation 3)
    owed = torch.where(j_plus, r_rd, zero)
    t_owed = row_sum(owed)
    reclaim = reclaim * torch.clamp_max(
        t_owed / torch.clamp_min(row_sum(reclaim), _EPS), 1.0)
    if integer_tokens:
        reclaim = torch.floor(reclaim)
    t_r = row_sum(reclaim)
    df_plus = torch.where(j_plus, df, zero)
    share_p = df_plus / torch.clamp_min(row_sum(df_plus), _EPS)
    add1 = torch.minimum(share_p * t_r, owed)
    headroom = owed - add1
    leftover = t_r - row_sum(add1)
    add_raw = add1 + leftover * headroom / torch.clamp_min(
        row_sum(headroom), _EPS)
    add_rc, rem = dist(add_raw, rem, t_r, j_plus)
    alpha_rc = alpha_rd - reclaim + add_rc
    r_rc = r_rd + reclaim - add_rc

    alloc = torch.where(active, alpha_rc, zero)
    return alloc, r_rc, rem


def fleet_allocate(state: AllocatorState, demand, nodes, capacity, *,
                   u_max: float = 64.0, integer_tokens: bool = True
                   ) -> Tuple[AllocatorState, torch.Tensor]:
    """Decentralized fleet allocation.

    state fields, demand: [O, J]; nodes: [J] or [O, J]; capacity: scalar or
    [O].  Returns (new_state, alloc) with alloc the next window's [O, J]
    token budget (0 for inactive jobs).
    """
    n_ost = demand.shape[0]
    nodes = torch.broadcast_to(nodes.to(demand.dtype), demand.shape)
    capacity = torch.broadcast_to(
        torch.as_tensor(capacity, dtype=demand.dtype, device=demand.device),
        (n_ost,)).reshape(n_ost, 1)
    alloc, record, remainder = alloc_rows(
        demand, nodes, state.record, state.remainder, state.alloc_prev,
        capacity, u_max, integer_tokens)
    return AllocatorState(record=record, remainder=remainder,
                          alloc_prev=alloc), alloc


def allocate(state: AllocatorState, demand, nodes, capacity, *,
             u_max: float = 64.0, integer_tokens: bool = True
             ) -> Tuple[AllocatorState, torch.Tensor]:
    """One target's allocation: the O=1 view of ``fleet_allocate``.

    state fields, demand, nodes: [J]; capacity: scalar."""
    new, alloc = fleet_allocate(
        AllocatorState(*(x[None] for x in state)), demand[None], nodes[None],
        capacity, u_max=u_max, integer_tokens=integer_tokens)
    return AllocatorState(*(x[0] for x in new)), alloc[0]
