"""AdapTBF core: the paper's decentralized adaptive token borrowing allocator."""
from repro_torch.core.adaptbf import allocate, fleet_allocate
from repro_torch.core.baselines import static_allocate
from repro_torch.core.policies import (
    ControlPolicy,
    PolicyContext,
    WindowObs,
    get_policy,
    list_policies,
    register_policy,
)
from repro_torch.core.remainder import (
    integerize,
    passthrough,
    rank_desc,
    topk_mask,
)
from repro_torch.core.state import (
    AllocatorState,
    init_fleet_state,
    init_state,
)

__all__ = [
    "allocate",
    "fleet_allocate",
    "static_allocate",
    "ControlPolicy",
    "PolicyContext",
    "WindowObs",
    "get_policy",
    "list_policies",
    "register_policy",
    "integerize",
    "passthrough",
    "rank_desc",
    "topk_mask",
    "AllocatorState",
    "init_state",
    "init_fleet_state",
]
