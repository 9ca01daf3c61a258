"""The port keeps the reference's public names: every name in the
``__all__`` of a ported reference module exists in the port's counterpart,
and every public top-level function and class of a ported reference module
without an ``__all__`` does too.  Names the port does not have yet are listed
in ``NOT_YET`` with the ROADMAP item that ports each (none now); a listed
name that appears in the port fails the test."""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro_torch.core import no_bw_allocate

# reference name -> the ROADMAP.md queue A item that ports it
NOT_YET = {}

WITH_ALL = ["core", "storage", "models", "serving", "kernels.fleet_window",
            "kernels.window_mega", "checkpoint", "data", "optim", "training"]
WITHOUT_ALL = ["configs.shapes", "launch.steps", "launch.mesh",
               "launch.train", "launch.specs", "launch.roofline",
               "kernels.adaptbf_alloc.ops", "kernels.attention.ops",
               "kernels.ssd.ops", "storage.telemetry", "storage.metrics",
               "storage.service", "storage.workloads", "checkpoint.manager",
               "data.pipeline", "optim.adamw", "training.trainer"]


# reference parameter -> the port's, where the port renames it on purpose:
# jax.random keys become torch.Generators; the roofline's collective bytes
# come from the port's counters (launch/mesh.collectives), not from HLO
RENAMED = {"key": "generator", "hlo_text": "counters"}


def _public_definitions(module):
    return [name for name, v in vars(module).items()
            if not name.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__]


@pytest.mark.parametrize("name", WITH_ALL + WITHOUT_ALL)
def test_port_module_has_the_reference_public_names(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    names = getattr(ref, "__all__", None)
    assert (names is not None) == (name in WITH_ALL), name
    if names is None:
        names = _public_definitions(ref)
    assert names, name
    later = NOT_YET.get(name, {})
    missing = sorted(n for n in names if not hasattr(port, n))
    assert missing == sorted(n for n in later if n in names), (
        f"repro_torch.{name} lacks {missing}; listed as not yet ported: "
        f"{sorted(later)}")
    port_all = getattr(port, "__all__", None)
    if port_all is not None:   # what the port defines, it exports
        assert not [n for n in names if hasattr(port, n)
                    and n not in port_all], name


def test_c2_names_import():
    from repro_torch.storage import (  # noqa: F401
        route_progressive,
        route_round_robin,
        stripe_targets,
    )
    import repro_torch.storage as st
    assert {"route_progressive", "route_round_robin",
            "stripe_targets"} <= set(st.__all__)
    import repro_torch.core as core
    assert "no_bw_allocate" in core.__all__


@pytest.mark.parametrize("shape,cap", [
    ((7,), 123.0), ((3, 5), 40.0), ((4, 6), np.arange(6, dtype=np.float32)),
    ((2, 3, 4), np.float32(1e30))])
def test_no_bw_allocate_matches_reference(shape, cap):
    demand = np.random.default_rng(len(shape)).integers(
        0, 50, shape).astype(np.float32)
    want = np.asarray(jbase.no_bw_allocate(jnp.asarray(demand),
                                           jnp.asarray(cap)))
    got = no_bw_allocate(torch.from_numpy(demand), torch.as_tensor(cap))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got = no_bw_allocate(torch.from_numpy(demand), cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", WITH_ALL + WITHOUT_ALL + ["core.remainder"])
def test_port_functions_take_the_reference_parameters(name):
    """Every parameter of a reference public function exists in the port's
    counterpart (``RENAMED`` aside), so a reference caller's keywords are
    accepted: ``integerize(..., specialize=)`` and the kernel wrappers'
    ``interpret=`` among them."""
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    names = getattr(ref, "__all__", None) or _public_definitions(ref)
    missing = {}
    for n in names:
        a, b = getattr(ref, n, None), getattr(port, n, None)
        if not (inspect.isfunction(a) and inspect.isfunction(b)):
            continue
        have = set(inspect.signature(b).parameters)
        lost = [p for p in inspect.signature(a).parameters
                if p not in have and RENAMED.get(p) not in have]
        if lost:
            missing[n] = lost
    assert not missing, f"repro_torch.{name}: {missing}"


@pytest.mark.parametrize("name,kw", [
    ("core.remainder.integerize", "specialize"),
    ("kernels.adaptbf_alloc.ops.fleet_alloc", "interpret"),
    ("kernels.fleet_window.ops.fleet_window_serve", "interpret"),
    ("kernels.window_mega.ops.mega_window_round", "interpret")])
def test_reference_keywords_accepted(name, kw):
    mod, fn = name.rsplit(".", 1)
    params = inspect.signature(
        getattr(importlib.import_module(f"repro_torch.{mod}"), fn)).parameters
    assert params[kw].kind == inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("specialize", [False, True])
def test_integerize_specialize_is_bitwise_the_default(specialize):
    from repro_torch.core.remainder import integerize
    rng = np.random.default_rng(7)
    raw = torch.from_numpy(rng.uniform(0, 9, (6, 33)).astype(np.float32))
    rem = torch.from_numpy(rng.uniform(-0.5, 1, (6, 33)).astype(np.float32))
    mask = torch.from_numpy(rng.random((6, 33)) < 0.7)
    budget = torch.tensor([[0.], [5.], [40.], [120.], [300.], [7.]])
    want = integerize(raw, rem, budget, mask)
    got = integerize(raw, rem, budget, mask, specialize=specialize)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
