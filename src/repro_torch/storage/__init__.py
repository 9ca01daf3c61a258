"""Storage substrate: the discrete-time fleet simulator, client striping
policies, the seeded scenario generator and the AdapTBF I/O control plane
for the framework's own traffic."""
from repro_torch.core.policies import (
    ControlPolicy,
    control_codes,
    get_policy,
    list_policies,
    register_policy,
)
from repro_torch.storage import faults, scengen
from repro_torch.storage.controller import RPC_BYTES, AdapTBFController
from repro_torch.storage.faults import FaultPlan, no_faults, random_fault_plan
from repro_torch.storage.scengen import PROFILES, JobSpec, Trace, build_fleet, random_fleet
from repro_torch.storage.simulator import (
    DEFAULT_CODED_POLICIES,
    FLEET_CONTROL_CODES,
    FleetConfig,
    FleetResult,
    HeldObs,
    SimConfig,
    SimResult,
    WindowCarry,
    WindowOut,
    carry_from_numpy,
    carry_to_numpy,
    init_carry,
    simulate,
    simulate_fleet,
    window_step,
)
from repro_torch.storage.striping import (
    FleetDemand,
    route,
    route_progressive,
    route_round_robin,
    stripe_targets,
    stripe_weights,
)
from repro_torch.storage.workloads import FleetScenario, Scenario

__all__ = [
    "ControlPolicy",
    "control_codes",
    "get_policy",
    "list_policies",
    "register_policy",
    "faults",
    "RPC_BYTES",
    "AdapTBFController",
    "scengen",
    "FaultPlan",
    "no_faults",
    "random_fault_plan",
    "PROFILES",
    "JobSpec",
    "Trace",
    "build_fleet",
    "random_fleet",
    "DEFAULT_CODED_POLICIES",
    "FLEET_CONTROL_CODES",
    "FleetConfig",
    "FleetResult",
    "HeldObs",
    "SimConfig",
    "SimResult",
    "WindowCarry",
    "WindowOut",
    "carry_from_numpy",
    "carry_to_numpy",
    "init_carry",
    "simulate",
    "simulate_fleet",
    "window_step",
    "FleetDemand",
    "route",
    "route_progressive",
    "route_round_robin",
    "stripe_targets",
    "stripe_weights",
    "FleetScenario",
    "Scenario",
]
