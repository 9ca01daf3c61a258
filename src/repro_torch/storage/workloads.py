"""Scenario containers for the simulators (the numpy arrays a scenario
builder hands to ``simulate`` and ``simulate_fleet``).

Scaling: 1 RPC = 1 MB.  The named scenario registry is not ported yet
(ROADMAP queue A); ``scengen.random_fleet`` builds ``FleetScenario``s.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Scenario(NamedTuple):
    name: str
    nodes: np.ndarray        # [J] compute nodes (priorities)
    issue_rate: np.ndarray   # [T, J] RPCs/tick
    volume: np.ndarray       # [J] total RPCs (inf = unbounded)
    max_backlog: np.ndarray  # [J] client in-flight cap
    duration_s: float
    tick_seconds: float = 0.01


class FleetScenario(NamedTuple):
    name: str
    nodes: np.ndarray              # [J] compute nodes (priorities)
    issue_rate: np.ndarray         # [T, O, J] RPCs/tick routed per target
    volume: np.ndarray             # [O, J] total RPCs per target
    max_backlog: np.ndarray        # [O, J] client in-flight cap per target
    capacity_per_tick: np.ndarray  # [O] per-OST service rate (RPCs/tick)
    duration_s: float
    tick_seconds: float = 0.01

    @property
    def n_ost(self) -> int:
        return self.issue_rate.shape[1]
