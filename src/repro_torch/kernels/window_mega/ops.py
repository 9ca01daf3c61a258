"""Dispatching wrapper for the window megakernel
(``kernels/csrc/window_mega.cu``): CUDA tensors launch it, CPU tensors take
the plain version (``ref.py``), anything else raises.

The kernel has one case per built-in policy, picked by the policy class's
``device_id`` (``megakernel_case``); a coded policy launches the case of its
selected member, and per-row codes (a batch of fleets) launch once for each
distinct code, over that code's rows.

On the card a row takes at most ``dispatch.MAX_JOBS`` (65536) jobs: rows of
up to 32 run on one warp, 16 rows a block, rows of up to 8192 on one thread
block, wider rows on a thread-block cluster of 2, 4 or 8 blocks
(``dispatch.row_layout``, ``dispatch.cluster_size``).  A wider row raises
``ValueError`` before any launch; CPU tensors run the plain version at any
width.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.policies import AdapTBFPolicy, AIMDPolicy, CodedPolicy
from repro_torch.core.state import AllocatorState
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (
    check_f32,
    check_rates,
    cluster_size,
    route,
)
from repro_torch.kernels.window_mega import ref

#: kernel launches made by ``mega_window_round`` (never by the plain version)
launches = 0

_ROADMAP = "ROADMAP.md, queue B, item 9, \"Megakernel coverage\""

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
                    "u_max", "ai_frac", "md", "sat", "floor")]
                + [("rows", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in (
                    "n_rows", "rows_per_fleet", "rate_fleet_rows")])


_ARGTYPES = [ctypes.POINTER(_Params), ctypes.c_void_p]

#: what a subclass of a built-in may define and still run its base's case:
#: its registered name and the constants the kernel takes as inputs
#: (AIMD's), and ``__init__``, whose instance attributes are held to the
#: same list; any other method or attribute (``step``, ``_reclaim``, a new
#: helper) may change what the class computes
_INPUTS = ("name", "ai_frac", "md", "sat", "floor")


def _neutral(name: str, value) -> bool:
    """Whether a class attribute leaves its base's computation as it is:
    a kernel input, ``__init__``, or a dunder that is no method (what
    Python sets on every class: ``__module__``, ``__doc__``, ...)."""
    if name in _INPUTS or name == "__init__":
        return True
    return (name.startswith("__") and name.endswith("__")
            and not callable(value))


def megakernel_case(policy) -> Optional[int]:
    """The megakernel case (``device_id``) that runs ``policy``: the id of
    the nearest class in its MRO that declares one, unless a class before
    it, or the instance, defines anything but the kernel's inputs
    (``_INPUTS``).  So a subclass of a built-in that only renames it or
    tunes AIMD's constants runs its base's case; a custom policy, or a
    subclass that overrides a method or adds one (``_reclaim`` included),
    has none (None)."""
    if not all(k in _INPUTS for k in getattr(policy, "__dict__", ())):
        return None
    return _case_of_class(type(policy))


@functools.lru_cache(maxsize=None)
def _case_of_class(policy_class) -> Optional[int]:
    for cls in policy_class.__mro__:
        if "device_id" in vars(cls):
            return vars(cls)["device_id"]
        if not all(_neutral(k, v) for k, v in vars(cls).items()):
            return None
    return None


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


def _selected(policy, code):
    """(member policy, its index in a coded state or None, whether its
    state advances) for one control code.  A code outside the member range
    selects the last member's gate and allocation and advances no state,
    as the where-chain of ``CodedPolicy`` does."""
    if not isinstance(policy, CodedPolicy):
        return policy, None, True
    code = int(code)
    n = len(policy.members)
    sel = code if 0 <= code < n else n - 1
    return policy.members[sel], sel, 0 <= code < n


def mega_window_round(policy, ctx, cap_tick, backlog_cap, queue, vol_left,
                      alloc, held, pstate, rates_w, telem_ok=None, up=None,
                      code_rows=None, *, interpret: bool = None):
    """One fused control round: gate -> serve all ticks -> observation
    select -> policy step.

    queue/vol_left/alloc/backlog_cap: [R, J]; held: (served, demand, alloc)
    last-delivered rows; pstate: the policy-state tree (every leaf
    [R, ...], [R, J] on the card); rates_w: [W, R, J] fault-scaled issue
    attempts, or [F, W, O, J] for F fleets of O rows (R = F * O, the fleet
    axis of any stride); cap_tick: [R] effective per-tick rate
    (``ctx.cap_w`` must be its window total); telem_ok/up: optional [R]
    fault columns.  ``ctx.control_code`` may be an [R, 1] int32 column of
    per-row codes (a coded policy over a batch of fleets); the card then
    needs ``code_rows`` (``storage.simulator.FleetAxis.code_rows``) and
    launches once for each distinct code.  ``interpret`` is accepted for
    the reference's signature and ignored.

    Returns (queue, vol_left, served_w, demand, obs_served, obs_demand,
    obs_alloc, pstate, alloc_next): the obs triple is the next held state;
    the trajectory record stays with the caller
    (``storage.simulator.window_step``).  On the card every output is a
    fresh buffer, apart from the obs triple without faults (the served,
    demand and input allocation tensors themselves, as the plain version
    returns them) and state the round does not advance.
    """
    global launches
    r, j = queue.shape
    leaves = _flatten_state(pstate, r)
    faults = () if telem_ok is None else (telem_ok, up, *held)
    if not route(queue, vol_left, alloc, backlog_cap, rates_w, cap_tick,
                 ctx.nodes, ctx.cap_w, *leaves, *faults):
        return ref.mega_round_ref(policy, ctx, cap_tick, backlog_cap, queue,
                                  vol_left, alloc, held, pstate, rates_w,
                                  telem_ok, up)
    _check_oj(leaves, r, j)
    code = ctx.control_code
    if isinstance(code, torch.Tensor) and code.ndim > 0:
        if not isinstance(policy, CodedPolicy) or not code_rows:
            raise ValueError(
                "per-row control codes need a coded policy and code_rows, "
                "the rows of each distinct code")
        groups = [(c, rows, code == c) for c, rows in code_rows]
    else:
        groups = [(code, None, None)]
    picks = [(*_selected(policy, c), rows, mask) for c, rows, mask in groups]
    for member, *_ in picks:
        if megakernel_case(member) is None:
            raise NotImplementedError(
                f"the window megakernel has no case for policy "
                f"{member.name!r} ({type(member).__name__}): only the "
                "built-in policies and their subclasses that define nothing "
                f"but {', '.join(_INPUTS)} run on the card ({_ROADMAP})")
    cluster_size(j)   # raises past MAX_JOBS
    for name, x in (("queue", queue), ("vol_left", vol_left),
                    ("alloc", alloc), ("backlog_cap", backlog_cap),
                    ("nodes", ctx.nodes)):
        check_f32(name, x, (r, j))
    w, rows_per_fleet, fleet_rows = check_rates(rates_w, r, j)
    check_f32("cap_tick", cap_tick, (r,))
    check_f32("cap_w", ctx.cap_w, (r,))
    for member, sel, *_ in picks:
        mstate = pstate if sel is None else pstate[sel]
        for i, x in enumerate(_leaves(mstate)):
            check_f32(f"policy state leaf {i}", x, (r, j))
    if telem_ok is not None:
        check_f32("telem_ok", telem_ok, (r,))
        check_f32("up", up, (r,))
        for name, x in zip(("served", "demand", "alloc"), held):
            check_f32(f"held {name}", x, (r, j))

    def new():
        return torch.empty_like(queue)

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
    stream = torch.cuda.current_stream(queue.device).cuda_stream
    advanced = {}   # member index (None: not coded) -> its new state
    for member, sel, advance, rows, mask in picks:
        mstate = pstate if sel is None else pstate[sel]
        device_id = megakernel_case(member)
        p = _Params(n_ost=r, n_jobs=j, n_ticks=w, policy=device_id,
                    has_faults=telem_ok is not None,
                    integer_tokens=bool(ctx.integer_tokens),
                    u_max=ctx.u_max, rows=None if rows is None
                    else rows.data_ptr(),
                    n_rows=r if rows is None else rows.numel(),
                    rows_per_fleet=rows_per_fleet,
                    rate_fleet_rows=fleet_rows)

        def state_out(x):
            """Where the launch writes a state leaf: a fresh buffer for a
            launch over every row; over listed rows, a copy of the input
            that the launch overwrites in its rows only; a scratch buffer
            when the state does not advance."""
            if not advance:
                return new()
            return new() if rows is None else x.clone()

        args = {}
        if device_id == AdapTBFPolicy.device_id:
            if not isinstance(mstate, AllocatorState):
                raise TypeError("adaptbf state must be an AllocatorState")
            args.update(state0=mstate.record, state1=mstate.remainder,
                        state2=mstate.alloc_prev,
                        state0_out=state_out(mstate.record),
                        state1_out=state_out(mstate.remainder))
        elif device_id == AIMDPolicy.device_id:
            if not isinstance(mstate, torch.Tensor):
                raise TypeError("aimd state must be the [O, J] rate tensor")
            args.update(state0=mstate, state0_out=state_out(mstate))
            p.ai_frac, p.md = member.ai_frac, member.md
            p.sat, p.floor = member.sat, member.floor
        if advance and args:
            advanced[sel] = (args, mask)
        for name, x in {**ins, **outs, **args}.items():
            setattr(p, name, x.data_ptr())
        _build.launch("window_mega", _ARGTYPES, ctypes.byref(p), stream)
        launches += 1

    alloc_next = outs["alloc_out"]

    def advanced_state(sel, old):
        if sel not in advanced:
            return old
        args, mask = advanced[sel]
        if "state1_out" not in args:                       # aimd's rates
            return args["state0_out"]
        # adaptbf's alloc_prev is the next allocation in the rows it ran
        prev = (alloc_next if mask is None
                else torch.where(mask, alloc_next, old.alloc_prev))
        return AllocatorState(record=args["state0_out"],
                              remainder=args["state1_out"], alloc_prev=prev)

    if isinstance(policy, CodedPolicy):
        new_state = tuple(advanced_state(i, s) for i, s in enumerate(pstate))
    else:
        new_state = advanced_state(None, pstate)
    served, demand = outs["served_out"], outs["demand_out"]
    if telem_ok is None:
        obs = (served, demand, alloc)
    else:
        obs = (outs["obs_served_out"], outs["obs_demand_out"],
               outs["obs_alloc_out"])
    return (outs["queue_out"], outs["vol_out"], served, demand, *obs,
            new_state, alloc_next)
