#!/usr/bin/env python3
"""Instructions of one tick of a fleet kernel's tick loop, by class, from its
SASS (``cuobjdump -sass``, read by ``sass_diff.kernels``).

    python tools/sass_census.py LIB.so [LIB.so ...] \\
        [--only 'fleet_window_kernel<(int)8,'] [--json OUT]

For each kernel of each library whose demangled name (``sass_diff.
demangled``) holds ``--only``: its tick loops are the loops (a branch back
to an earlier address) whose body holds a block barrier (``BAR``) and no
other such loop (a kernel may run one tick loop for full blocks and one for
ragged ones; with no barrier anywhere, the largest loop); within each, the
paths from the loop's head to its branch back are walked
forward (branches back within the body and branches out of it end a
path), and for each count of barriers on a path the longest path is
reported, by class: ``F2F`` (float/double conversions), ``DADD``, ``SHFL``,
``BAR``, ``FP32`` (float32 arithmetic, compares, ``MUFU``), ``FP64`` (other
double operations), ``ALU`` (integer, logic, moves, uniform-datapath
operations), ``load``, ``store``, ``control`` (branches, convergence
barriers, calls) and ``other``; and the loop body's static counts.  A tick
whose second row sum is skipped runs a path with one barrier fewer than
the one that forms it.  Needs the CUDA toolkit's ``cuobjdump`` and
``cu++filt``."""
from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from sass_diff import demangled, kernels  # noqa: E402

CLASSES = ("F2F", "DADD", "SHFL", "BAR", "FP32", "FP64", "ALU", "load",
           "store", "control", "other")
_FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
         "MUFU", "FRND", "FSWZADD", "FMNMX3", "FADD32I", "FMUL32I", "FFMA32I"}
_FP64 = {"DMUL", "DFMA", "DSETP", "DMNMX"}
_LOAD = {"LDG", "LDS", "LDL", "LD", "LDC", "ULDC", "LDSM", "LDGSTS",
         "ATOMS", "ATOMG", "RED", "ATOM"}
_STORE = {"STG", "STS", "STL", "ST"}
_CONTROL = {"BRA", "BRX", "JMP", "JMX", "BSSY", "BSYNC", "WARPSYNC", "EXIT",
            "CALL", "RET", "NOP", "YIELD", "BMOV", "BPT", "KILL", "NANOSLEEP",
            "ACQBULK", "ELECT", "ENDCOLLECTIVE", "WARPGROUP", "MEMBAR"}
_HEX = re.compile(r"0x([0-9a-f]+)")


def split(text: str):
    """(guard, opcode with modifiers, operands) of one SASS instruction."""
    guard = ""
    if text.startswith("@"):
        guard, text = text.split(None, 1)
    op, _, rest = text.partition(" ")
    return guard, op, rest.strip()


def klass(op: str) -> str:
    base = op.split(".")[0]
    if base == "F2F":
        return "F2F"
    if base in ("DADD", "SHFL", "BAR"):
        return base
    if "CGABAR" in base:              # a cluster barrier's halves
        return "BAR"
    if base in _FP32:
        return "FP32"
    if base in _FP64:
        return "FP64"
    if base in _LOAD:
        return "load"
    if base in _STORE:
        return "store"
    if base in _CONTROL:
        return "control"
    if base[:1] in "IULPSCVMRB" or base in ("MOV", "SEL", "SHF", "LEA",
                                            "PRMT", "POPC", "FLO", "IMAD"):
        return "ALU"
    return "other"


def branch(guard: str, op: str, rest: str):
    """(target address or None, whether the branch may fall through) of a
    control-flow instruction; None for any other."""
    base = op.split(".")[0]
    if base not in ("BRA", "EXIT", "RET", "BRX", "JMP", "JMX"):
        return None
    conditional = (guard not in ("", "@PT") or "," in rest
                   or ".DIV" in op or base in ("BRX", "JMX"))
    hexes = _HEX.findall(rest)
    target = int(hexes[-1], 16) if base in ("BRA", "JMP") and hexes else None
    return target, conditional


def tick_loops(insns):
    """[(first, last) index] of the loops whose body holds a BAR and no
    other such loop, in address order; with no such loop, the largest
    loop; [] without a loop."""
    index = {a: i for i, (a, _) in enumerate(insns)}
    loops = []
    for i, (addr, text) in enumerate(insns):
        br = branch(*split(text))
        if br and br[0] is not None and br[0] <= addr and br[0] in index:
            first = index[br[0]]
            bars = sum(klass(split(t)[1]) == "BAR"
                       for _, t in insns[first:i + 1])
            loops.append((first, i, bars))
    barred = [(a, b) for a, b, n in loops if n]
    inner = [(a, b) for a, b in barred
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in barred)]
    if inner:
        return sorted(inner)
    return [max(((a, b) for a, b, _ in loops), key=lambda x: x[1] - x[0],
                default=None)] if loops else []


def paths(insns, first: int, last: int):
    """{barriers on a path: Counter of classes of the longest such path}
    over the forward paths from instruction ``first`` to ``last`` (the
    branch back)."""
    body = insns[first:last + 1]
    index = {a: k for k, (a, _) in enumerate(body)}
    n = len(body)
    # best[k]: {bars: (length, Counter)} of paths from the head to k
    best = [dict() for _ in range(n + 1)]
    best[0][0] = (0, Counter())
    for k, (addr, text) in enumerate(body):
        here = best[k]
        if not here:
            continue
        guard, op, rest = split(text)
        c = klass(op)
        bar = c == "BAR"
        stepped = {b + bar: (length + 1, cnt + Counter({c: 1}))
                   for b, (length, cnt) in here.items()}
        if k == n - 1:          # the branch back: a whole tick
            best[n] = stepped
            break
        succ = []
        br = branch(guard, op, rest)
        if br is None:
            succ.append(k + 1)
        else:
            target, falls = br
            if target is not None and target > addr and target in index:
                succ.append(index[target])
            if falls:
                succ.append(k + 1)
        for s in succ:
            for b, (length, cnt) in stepped.items():
                if b not in best[s] or best[s][b][0] < length:
                    best[s][b] = (length, cnt)
    return {b: cnt for b, (_, cnt) in sorted(best[n].items())}


def census(insns):
    """[{"static": Counter, "paths": {bars: Counter}}] of a kernel's tick
    loops ([] when it has no loop)."""
    return [{"static": Counter(klass(split(t)[1])
                               for _, t in insns[first:last + 1]),
             "paths": paths(insns, first, last)}
            for first, last in tick_loops(insns)]


def row(counts) -> dict:
    out = {c: counts.get(c, 0) for c in CLASSES}
    out["total"] = sum(counts.values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("libs", type=Path, nargs="+")
    ap.add_argument("--only", default="fleet_window_kernel<(int)8,")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tools = Path(nvcc).parent
    out = {}
    for lib in args.libs:
        found = kernels(lib, str(tools / "cuobjdump"), strip=False,
                        addresses=True)
        names = demangled(found, str(tools / "cu++filt"))
        for mangled, insns in found.items():
            name = names[mangled]
            if args.only not in name:
                continue
            key = f"{lib}: {name}"
            loops = census(insns)
            if not loops:
                print(f"{key}: no loop")
            out[key] = []
            for k, got in enumerate(loops):
                out[key].append({"static": row(got["static"]),
                                 "paths": {str(b): row(c) for b, c in
                                           got["paths"].items()}})
                print(f"{key}: tick loop {k}, its body static: "
                      + ", ".join(f"{c} {v}" for c, v in
                                  out[key][-1]["static"].items()))
                for b, r in out[key][-1]["paths"].items():
                    print(f"  longest tick with {b} barrier(s): "
                          + ", ".join(f"{c} {v}" for c, v in r.items()))
    if args.json:
        args.json.write_text(json.dumps(out, indent=1))
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
