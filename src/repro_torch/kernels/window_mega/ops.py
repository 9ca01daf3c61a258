"""Dispatching wrapper for the window megakernel
(``kernels/csrc/window_mega.cu``): CUDA tensors launch it, CPU tensors take
the plain version (``ref.py``), anything else raises.

The kernel has one case per built-in policy, picked by the policy class's
``device_id``; a coded policy launches the case of its selected member.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.policies import AdapTBFPolicy, AIMDPolicy, CodedPolicy
from repro_torch.core.state import AllocatorState
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import MAX_JOBS, check_f32, route
from repro_torch.kernels.window_mega import ref

#: kernel launches made by ``mega_window_round`` (never by the plain version)
launches = 0

_ROADMAP = "ROADMAP.md, queue A, \"Megakernel coverage\""

_IN = ("queue", "vol", "alloc", "held_served", "held_demand", "held_alloc",
       "state0", "state1", "state2", "nodes", "backlog", "rates", "cap_tick",
       "cap_w", "telem_ok", "up")
_OUT = ("queue_out", "vol_out", "served_out", "demand_out", "obs_served_out",
        "obs_demand_out", "obs_alloc_out", "alloc_out", "state0_out",
        "state1_out")


class _Params(ctypes.Structure):
    """``MegaParams`` of ``csrc/window_mega.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _IN + _OUT]
                + [(name, ctypes.c_int) for name in (
                    "n_ost", "n_jobs", "n_ticks", "policy", "has_faults",
                    "integer_tokens")]
                + [(name, ctypes.c_float) for name in (
                    "u_max", "ai_frac", "md", "sat", "floor")])


_ARGTYPES = [ctypes.POINTER(_Params), ctypes.c_void_p]


def _leaves(tree):
    """The tensors of a policy-state tree (tuples, named tuples, lists and
    dicts by sorted key, as a pytree flattens)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _leaves(item)]
    raise TypeError(f"policy state holds a {type(tree).__name__}; expected "
                    "tensors in tuples, lists or dicts")


def _flatten_state(pstate, o: int):
    leaves = _leaves(pstate)
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != o:
            raise ValueError(
                "serve_backend=\"mega\" needs every policy-state leaf to "
                f"carry a leading OST axis (shape[0] == {o}); got a leaf "
                f"of shape {tuple(leaf.shape)}.  Row-less state cannot be "
                "blocked over OST rows.")
    return leaves


def _check_oj(leaves, o: int, j: int) -> None:
    for leaf in leaves:
        if tuple(leaf.shape) != (o, j):
            raise ValueError(
                "the megakernel blocks policy-state leaves as [O, J] rows; "
                f"got a leaf of shape {tuple(leaf.shape)} (expected "
                f"{(o, j)})")


def _selected(policy, ctx, pstate):
    """(member policy, its state, index in a coded state or None, whether
    its state advances).  A code outside the member range selects the last
    member's gate and allocation and advances no state, as the where-chain
    of ``CodedPolicy`` does."""
    if not isinstance(policy, CodedPolicy):
        return policy, pstate, None, True
    code = int(ctx.control_code)
    n = len(policy.members)
    sel = code if 0 <= code < n else n - 1
    return policy.members[sel], pstate[sel], sel, 0 <= code < n


def mega_window_round(policy, ctx, cap_tick, backlog_cap, queue, vol_left,
                      alloc, held, pstate, rates_w, telem_ok=None, up=None):
    """One fused control round: gate -> serve all ticks -> observation
    select -> policy step.

    queue/vol_left/alloc/backlog_cap: [O, J]; held: (served, demand, alloc)
    last-delivered rows; pstate: the policy-state tree (every leaf
    [O, ...], [O, J] on the card); rates_w: [W, O, J] fault-scaled issue
    attempts; cap_tick: [O] effective per-tick rate (``ctx.cap_w`` must be
    its window total); telem_ok/up: optional [O] fault columns.

    Returns (queue, vol_left, served_w, demand, obs_served, obs_demand,
    obs_alloc, pstate, alloc_next): the obs triple is the next held state;
    the trajectory record stays with the caller
    (``storage.simulator.window_step``).  On the card every output is a
    fresh buffer, apart from the obs triple without faults (the served,
    demand and input allocation tensors themselves, as the plain version
    returns them) and state the round does not advance.
    """
    global launches
    o, j = queue.shape
    leaves = _flatten_state(pstate, o)
    faults = () if telem_ok is None else (telem_ok, up, *held)
    if not route(queue, vol_left, alloc, backlog_cap, rates_w, cap_tick,
                 ctx.nodes, ctx.cap_w, *leaves, *faults):
        return ref.mega_round_ref(policy, ctx, cap_tick, backlog_cap, queue,
                                  vol_left, alloc, held, pstate, rates_w,
                                  telem_ok, up)
    _check_oj(leaves, o, j)
    member, mstate, sel, advance = _selected(policy, ctx, pstate)
    device_id = type(member).__dict__.get("device_id")
    if device_id is None:
        raise NotImplementedError(
            f"the window megakernel has no case for policy {member.name!r} "
            f"({type(member).__name__}): only the built-in policies run on "
            f"the card ({_ROADMAP})")
    if j > MAX_JOBS:
        raise NotImplementedError(
            f"the window megakernel takes at most {MAX_JOBS} jobs per row, "
            f"got {j} ({_ROADMAP})")
    w = rates_w.shape[0]
    for name, x in (("queue", queue), ("vol_left", vol_left),
                    ("alloc", alloc), ("backlog_cap", backlog_cap),
                    ("nodes", ctx.nodes)):
        check_f32(name, x, (o, j))
    check_f32("rates_w", rates_w, (w, o, j))
    check_f32("cap_tick", cap_tick, (o,))
    check_f32("cap_w", ctx.cap_w, (o,))
    for i, x in enumerate(_leaves(mstate)):
        check_f32(f"policy state leaf {i}", x, (o, j))
    if telem_ok is not None:
        check_f32("telem_ok", telem_ok, (o,))
        check_f32("up", up, (o,))
        for name, x in zip(("served", "demand", "alloc"), held):
            check_f32(f"held {name}", x, (o, j))

    def new():
        return torch.empty_like(queue)

    p = _Params(n_ost=o, n_jobs=j, n_ticks=w, policy=device_id,
                has_faults=telem_ok is not None,
                integer_tokens=bool(ctx.integer_tokens), u_max=ctx.u_max)
    ins = dict(queue=queue, vol=vol_left, alloc=alloc, nodes=ctx.nodes,
               backlog=backlog_cap, rates=rates_w, cap_tick=cap_tick,
               cap_w=ctx.cap_w)
    outs = dict(queue_out=new(), vol_out=new(), served_out=new(),
                demand_out=new(), alloc_out=new())
    if telem_ok is not None:
        ins.update(telem_ok=telem_ok, up=up, held_served=held[0],
                   held_demand=held[1], held_alloc=held[2])
        outs.update(obs_served_out=new(), obs_demand_out=new(),
                    obs_alloc_out=new())
    adaptbf = device_id == AdapTBFPolicy.device_id
    aimd = device_id == AIMDPolicy.device_id
    if adaptbf:
        if not isinstance(mstate, AllocatorState):
            raise TypeError("adaptbf state must be an AllocatorState")
        ins.update(state0=mstate.record, state1=mstate.remainder,
                   state2=mstate.alloc_prev)
        outs.update(state0_out=new(), state1_out=new())
    elif aimd:
        if not isinstance(mstate, torch.Tensor):
            raise TypeError("aimd state must be the [O, J] rate tensor")
        ins.update(state0=mstate)
        outs.update(state0_out=new())
        p.ai_frac, p.md = member.ai_frac, member.md
        p.sat, p.floor = member.sat, member.floor
    for name, x in {**ins, **outs}.items():
        setattr(p, name, x.data_ptr())
    _build.launch("window_mega", _ARGTYPES, ctypes.byref(p),
                  torch.cuda.current_stream(queue.device).cuda_stream)
    launches += 1

    alloc_next = outs["alloc_out"]
    if adaptbf:
        new_state = AllocatorState(record=outs["state0_out"],
                                   remainder=outs["state1_out"],
                                   alloc_prev=alloc_next)
    elif aimd:
        new_state = outs["state0_out"]
    else:
        new_state = mstate
    if sel is not None:
        new_state = tuple(new_state if i == sel and advance else s
                          for i, s in enumerate(pstate))
    served, demand = outs["served_out"], outs["demand_out"]
    if telem_ok is None:
        obs = (served, demand, alloc)
    else:
        obs = (outs["obs_served_out"], outs["obs_demand_out"],
               outs["obs_alloc_out"])
    return (outs["queue_out"], outs["vol_out"], served, demand, *obs,
            new_state, alloc_next)
