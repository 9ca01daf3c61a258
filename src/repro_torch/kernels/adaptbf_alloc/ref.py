"""Plain version of the allocation kernel: the core allocator itself.  The
CUDA kernel must match it (integer tokens, identical tie-breaking)."""
from __future__ import annotations

from repro_torch.core.adaptbf import fleet_allocate
from repro_torch.core.state import AllocatorState


def fleet_alloc_ref(demand, nodes, record, remainder, alloc_prev, capacity,
                    *, u_max: float = 64.0):
    """demand/nodes/record/remainder/alloc_prev: [O, J]; capacity: [O].
    Returns (alloc, new_record, new_remainder, new_alloc_prev)."""
    state = AllocatorState(record=record, remainder=remainder,
                           alloc_prev=alloc_prev)
    new_state, alloc = fleet_allocate(state, demand, nodes, capacity,
                                      u_max=u_max, integer_tokens=True)
    return alloc, new_state.record, new_state.remainder, new_state.alloc_prev
