"""AdapTBF core: the paper's decentralized adaptive token borrowing allocator."""
from repro_torch.core.adaptbf import allocate, fleet_allocate
from repro_torch.core.baselines import no_bw_allocate, static_allocate
from repro_torch.core.policies import (
    CodedPolicy,
    ControlPolicy,
    PolicyContext,
    WindowObs,
    control_codes,
    get_policy,
    list_policies,
    register_policy,
    select_by_code,
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
    "no_bw_allocate",
    "CodedPolicy",
    "ControlPolicy",
    "PolicyContext",
    "WindowObs",
    "control_codes",
    "get_policy",
    "list_policies",
    "register_policy",
    "select_by_code",
    "integerize",
    "passthrough",
    "rank_desc",
    "topk_mask",
    "AllocatorState",
    "init_state",
    "init_fleet_state",
]
