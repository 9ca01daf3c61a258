"""Storage substrate: the discrete-time fleet simulator, client striping
policies and the seeded scenario generator."""
from repro_torch.core.policies import get_policy, list_policies, register_policy
from repro_torch.storage import faults, scengen
from repro_torch.storage.faults import FaultPlan, no_faults, random_fault_plan
from repro_torch.storage.scengen import PROFILES, JobSpec, Trace, build_fleet, random_fleet
from repro_torch.storage.simulator import (
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
from repro_torch.storage.striping import FleetDemand, route, stripe_weights
from repro_torch.storage.workloads import FleetScenario, Scenario

__all__ = [
    "get_policy",
    "list_policies",
    "register_policy",
    "faults",
    "scengen",
    "FaultPlan",
    "no_faults",
    "random_fault_plan",
    "PROFILES",
    "JobSpec",
    "Trace",
    "build_fleet",
    "random_fleet",
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
    "stripe_weights",
    "FleetScenario",
    "Scenario",
]
