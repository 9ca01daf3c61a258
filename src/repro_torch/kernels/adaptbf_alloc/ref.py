"""Plain version of the allocation kernel: the core allocator itself.  The
CUDA kernel must match it (integer tokens, identical tie-breaking).  Below
it, test-only plain models of the kernel's searches: the radix select and
excess descent of a block or cluster row, the direct rank and shuffled
descent of a warp row (``tests/test_torch_alloc_search.py``,
``tests/test_torch_narrow_rows.py``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.adaptbf import fleet_allocate
from repro_torch.core.state import AllocatorState
from repro_torch.kernels.dispatch import WARP_JOBS, cluster_size, row_layout


def fleet_alloc_ref(demand, nodes, record, remainder, alloc_prev, capacity,
                    *, u_max: float = 64.0):
    """demand/nodes/record/remainder/alloc_prev: [O, J]; capacity: [O].
    Returns (alloc, new_record, new_remainder, new_alloc_prev)."""
    state = AllocatorState(record=record, remainder=remainder,
                           alloc_prev=alloc_prev)
    new_state, alloc = fleet_allocate(state, demand, nodes, capacity,
                                      u_max=u_max, integer_tokens=True)
    return alloc, new_state.record, new_state.remainder, new_state.alloc_prev


# ---------------------------------------------------------------------------
# Plain models of the kernel's two searches (``csrc/alloc_round.cuh``),
# written digit by digit as the kernel runs them, so that the CPU tests can
# hold them bitwise against ``core/remainder.py`` and the reference's
# ``repro.core.remainder``.  Nothing on the main path calls them.
# Rows are [R, J] float32.  A row runs on ``blocks`` thread blocks (default:
# the kernels' rule, ``dispatch.cluster_size``), block q counting the slice
# of S = ceil(J / blocks) lanes from q * S, as a cluster runs it: the
# searches sum the slices' counts, and a tied lane's index rank adds the
# tied lanes of the lower slices, read from their last radix pass's counts
# (what the kernel adds into each higher rank's lower-ranks table).

_U32 = 0xFFFFFFFF


def _order_u32(key: torch.Tensor) -> torch.Tensor:
    """The reference's int32 order map (-0.0 tied to +0.0), as unsigned
    order in int64: larger key, larger value."""
    key = torch.where(key == 0.0, torch.zeros_like(key), key)
    bits = key.contiguous().view(torch.int32).to(torch.int64)
    ordv = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return (ordv & _U32) ^ 0x80000000


def _slices(j: int, blocks=None):
    """The [start, stop) lane ranges of a row's blocks, in rank order."""
    blocks = cluster_size(j) if blocks is None else blocks
    size = -(-j // blocks)
    return [(q * size, min(q * size + size, j)) for q in range(blocks)
            if q * size < j]


def topk_mask_radix(key: torch.Tensor, k, blocks=None) -> torch.Tensor:
    """Membership of the k largest keys of each row, ties to the lowest
    index, found as the kernel finds it: k <= 0 selects nothing and k >= J
    every lane; otherwise up to four passes over an 8-bit digit of the
    order map, each a 256-bin histogram of the lanes that share the digits
    found so far, from which the threshold's digit d (count(digit > d) <
    krem <= count(digit >= d)) and the rank left below it follow; a pass
    whose digit group holds exactly krem lanes selects that group and
    stops; after four passes the krem lowest-index lanes equal to the
    threshold are selected by a prefix count.  key [R, J], k [R] ints;
    each histogram is the sum of the row's blocks' (``_slices``), and the
    prefix count runs slice by slice, each slice's offset the tied lanes of
    the slices before it: the sum of their last pass's counts at the
    threshold's last digit."""
    u = _order_u32(key.to(torch.float32))
    rows, j = u.shape
    slices = _slices(j, blocks)
    ks = torch.as_tensor(k).reshape(-1).expand(rows).tolist()
    sel = torch.zeros((rows, j), dtype=torch.bool)
    for r, kr in enumerate(ks):
        if kr <= 0:
            continue
        if kr >= j:
            sel[r] = True
            continue
        ur, pre, krem = u[r], 0, int(kr)
        for pas in range(4):
            shift = 24 - 8 * pas
            hi = 0 if pas == 0 else (_U32 << (shift + 8)) & _U32
            per_slice = [torch.bincount((ur[a:b][(ur[a:b] & hi) == pre]
                                         >> shift) & 255, minlength=256)
                         for a, b in slices]
            hist = sum(per_slice)
            at_least = hist.flip(0).cumsum(0).flip(0)   # count(digit >= d)
            above = at_least - hist
            d = int(((above < krem) & (krem <= at_least)).nonzero()[0])
            krem -= int(above[d])
            pre |= d << shift
            if int(hist[d]) == krem:
                sel[r] = (ur & ((_U32 << shift) & _U32)) >= pre
                break
        else:
            tied = ur == pre
            rank = torch.empty(j, dtype=torch.int64)
            lower = 0   # tied lanes of the lower slices
            for (a, b), counts in zip(slices, per_slice):
                within = torch.cumsum(tied[a:b].to(torch.int64), 0)
                rank[a:b] = lower + within - 1
                lower += int(counts[pre & 255])
            sel[r] = (ur > pre) | (tied & (rank < krem))
    return sel


def excess_rounds(floored: torch.Tensor, d_dn: torch.Tensor, blocks=None):
    """The excess descent as the kernel runs it: p, the largest r < 2^25
    with g(r) = sum_j min(floored_j, r) <= d_dn, and g(p) as float32, in 5
    passes that evaluate g at the 32 candidates p + c 2^shift (c = 0..31,
    shift = 20, 15, ..., 0) as exact integer sums rounded once to float32.
    floored [R, J] integer-valued float32 >= 0 (0 off the mask); d_dn [R]
    float32; g sums the row's blocks' partials (``_slices``) in rank order.
    Returns (p [R] int64, g_p [R] float32)."""
    f = torch.clamp_max(floored.to(torch.float32), 2.0**25).to(torch.int64)
    rows = f.shape[0]
    slices = _slices(f.shape[1], blocks)
    p = torch.zeros(rows, dtype=torch.int64)
    g_p = torch.zeros(rows, dtype=torch.float32)
    c = torch.arange(32, dtype=torch.int64)
    for pas in range(5):
        shift = 20 - 5 * pas
        cand = p[:, None] + (c << shift)[None, :]                     # [R, 32]
        g = sum(torch.minimum(f[:, a:b, None], cand[:, None, :]).sum(1)
                for a, b in slices)                                   # exact
        gf = g.to(torch.float32)
        best = (gf <= d_dn.reshape(-1, 1)).sum(1) - 1   # g is nondecreasing in c
        g_p = gf.gather(1, best[:, None])[:, 0]
        p = p + (best << shift)
    return p, g_p


# The searches on a warp row (J <= ``dispatch.WARP_JOBS``: lane l holds job
# l), as ``alloc_round.cuh``'s ``WarpRed`` overloads run them.


def topk_mask_rank(key: torch.Tensor, k) -> torch.Tensor:
    """The top-k membership of a warp row, as the kernel finds it: k <= 0
    selects nothing and k >= J every lane; otherwise lane l's rank is the
    count of lanes m < J whose order-mapped key is larger than l's, or
    equal with m < l (the lanes read one at a time, m = 0, 1, ...), and
    the lane is selected when its rank is below k.  key [R, J], k [R]."""
    u = _order_u32(key.to(torch.float32))
    rows, j = u.shape
    ks = torch.as_tensor(k).reshape(-1).expand(rows).tolist()
    sel = torch.zeros((rows, j), dtype=torch.bool)
    lane = torch.arange(j)
    for r, kr in enumerate(ks):
        if kr <= 0:
            continue
        if kr >= j:
            sel[r] = True
            continue
        rank = torch.zeros(j, dtype=torch.int64)
        for m in range(j):
            um = u[r, m]
            rank += (um > u[r]) | ((um == u[r]) & (m < lane))
        sel[r] = rank < int(kr)
    return sel


def excess_rounds_warp(floored: torch.Tensor, d_dn: torch.Tensor):
    """The excess descent on a warp row, as the kernel runs it: the 5 passes
    of ``excess_rounds``, candidate p + c 2^shift on lane c, its sum of
    min(f_m, candidate) over the lanes m up to the last with a nonzero
    floor, in lane order (exact), rounded once to float32.  Returns
    (p [R] int64, g_p [R] float32)."""
    f = torch.clamp_max(floored.to(torch.float32), 2.0**25).to(torch.int64)
    rows, j = f.shape
    p = torch.zeros(rows, dtype=torch.int64)
    g_p = torch.zeros(rows, dtype=torch.float32)
    lanes = torch.arange(32, dtype=torch.int64)
    for r in range(rows):
        nonzero = (f[r] != 0).nonzero()
        n = int(nonzero[-1]) + 1 if len(nonzero) else 0
        pr, gr = 0, torch.tensor(0.0)
        for pas in range(5):
            shift = 20 - 5 * pas
            cand = pr + (lanes << shift)                   # lane c: candidate c
            total = torch.zeros(32, dtype=torch.int64)
            for m in range(n):
                total += torch.minimum(f[r, m], cand)
            gc = total.to(torch.float32)
            best = int((gc <= d_dn[r]).nonzero()[-1])      # highest ballot bit
            gr = gc[best]
            pr += best << shift
        p[r], g_p[r] = pr, gr
    return p, g_p


def integerize_model(raw, remainder, budget, mask, blocks=None, warp=False):
    """``core/remainder.py::integerize`` with the kernel's searches in place
    of the bit descent and the sort: rows [R, J], budget [R] or [R, 1],
    each row over ``blocks`` blocks (``_slices``), or with ``warp`` on one
    warp (``topk_mask_rank``, ``excess_rounds_warp``: the kernels' layout
    at J <= ``dispatch.WARP_JOBS``; ``ValueError`` past it)."""
    if warp and row_layout(raw.shape[-1]) != "warp":
        raise ValueError(f"a warp row holds at most {WARP_JOBS} jobs, not "
                         f"{raw.shape[-1]}")
    budget = torch.as_tensor(budget, dtype=torch.float32).reshape(-1, 1)
    zero = torch.zeros_like(raw)
    x = torch.where(mask, raw + remainder, zero)
    floored = torch.clamp_min(torch.floor(x), 0.0)
    rem = torch.where(mask, x - floored, zero)
    delta = torch.round(budget - floored.sum(-1, keepdim=True,
                                             dtype=torch.float64).float())
    delta_i = torch.clamp(delta, -(2.0**30), 2.0**30).to(torch.int32)
    n_masked = mask.sum(-1, keepdim=True, dtype=torch.int32)
    d_up = torch.clamp_min(delta_i, 0)
    q = torch.div(d_up, torch.clamp_min(n_masked, 1), rounding_mode="floor")
    k_up = d_up - q * n_masked
    d_dn = torch.clamp_min(-delta, 0.0)
    descent = excess_rounds_warp if warp else functools.partial(
        excess_rounds, blocks=blocks)
    p, g_p = descent(torch.where(mask, floored, zero), d_dn[:, 0])
    # rows that do not overshoot never run the descent (p = 0, g(p) = 0)
    down = delta[:, 0] < 0
    p = torch.where(down, p, torch.zeros_like(p))
    g_p = torch.where(down, g_p, torch.zeros_like(g_p))
    p_f = p.to(torch.float32)[:, None]
    k_dn = torch.clamp_max(d_dn - g_p[:, None], 2.0**30).to(torch.int32)
    elig = mask & (floored >= p_f + 1.0)
    is_up = delta > 0
    neg_inf = torch.full_like(raw, -torch.inf)
    key = torch.where(is_up, torch.where(mask, rem, neg_inf),
                      torch.where(elig, rem, neg_inf))
    k = torch.where(is_up, k_up, k_dn)[:, 0]
    sel = topk_mask_rank(key, k) if warp else topk_mask_radix(key, k, blocks)
    bump_up = q.to(torch.float32) * mask.to(torch.float32) + (sel & mask).to(
        torch.float32)
    bump_dn = torch.minimum(torch.where(mask, floored, zero), p_f) + (
        sel & elig).to(torch.float32)
    applied = torch.where(delta > 0, bump_up,
                          torch.where(delta < 0, -bump_dn, zero))
    return floored + applied, torch.where(mask, rem - applied, remainder)
