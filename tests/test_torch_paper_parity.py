"""The port's ``simulate`` regenerates the committed paper timelines
(``experiments/paper/*.csv``) from the port's scenario registry (its arrays
equal the reference's bitwise, ``tests/test_torch_workloads.py``),
at the reference's own tolerance (rtol = atol = 1e-5,
``tests/test_paper_parity.py``), column by column.

One exception: ``ivf_recompensation`` under ``adaptbf``.  There the
reference itself no longer reproduces its committed CSV on the installed
JAX (a one-ulp difference flips an integer tie and forks the closed loop;
``test_paper_parity[ivf_recompensation-adaptbf]`` fails on the reference
too), so the timeline is not a fixed point to compare against.  It is held
to what a fork leaves intact: each job's horizon total of served MB and the
number of windows.
"""
import numpy as np
import pytest
import torch
from test_paper_parity import CONTROLS, FIGURES, PAPER

from repro_torch.storage import SimConfig, get_scenario, simulate

torch.set_num_threads(1)

FORKED = {("ivf_recompensation", "adaptbf")}


def _regenerate(scenario_name: str, control: str) -> np.ndarray:
    """The column layout ``paper_figures._save_timeline`` writes: t_s, mb_s
    per job, lend/borrow record per job."""
    scn = get_scenario(scenario_name)
    res = simulate(SimConfig(control=control), scn.nodes, scn.issue_rate,
                   scn.volume, scn.max_backlog, device="cpu")
    thr = res.throughput_mb_s.numpy()
    rec = res.record.numpy()
    t = np.arange(thr.shape[0]) * res.window_seconds
    return np.column_stack([t, thr, rec])


@pytest.mark.parametrize("control", CONTROLS)
@pytest.mark.parametrize("stem", sorted(FIGURES))
def test_port_regenerates_paper_timeline(stem, control):
    scenario_name, _ = FIGURES[stem]
    disk = np.loadtxt(PAPER / f"{stem}_{control}.csv", delimiter=",",
                      skiprows=1)
    regen = _regenerate(scenario_name, control)
    assert disk.shape == regen.shape
    if (stem, control) in FORKED:
        n_jobs = (disk.shape[1] - 1) // 2
        mb = slice(1, 1 + n_jobs)
        np.testing.assert_allclose(regen[:, mb].sum(axis=0),
                                   disk[:, mb].sum(axis=0), rtol=5e-3,
                                   err_msg="per-job horizon MB")
        return
    np.testing.assert_allclose(regen, disk, rtol=1e-5, atol=1e-5,
                               err_msg=f"{stem}_{control}")
