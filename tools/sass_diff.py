#!/usr/bin/env python3
"""Whether a CUDA library's kernels compiled to the same machine code as
another build's: for each kernel of OLD, its SASS instructions
(``cuobjdump -sass``) against those of the kernel of NEW with the same
name, after OLD's names are rewritten by the ``--rename`` rules (regex,
replacement), with the anonymous-namespace tags that nvcc derives from
each build stripped.

    python tools/sass_diff.py OLD.so NEW.so [--only SUBSTR] \\
        [--rename 'ILi(\\d+)EE$' 'ILi\\1ELb0EE' ...]
    python tools/sass_diff.py OLD.so NEW.so --demangle \\
        --rename ',\\(bool\\)([01])>$' ',repro::RowBlock<(bool)\\1>>'

Prints one line a kernel (same, differs, missing) and exits 1 unless every
selected kernel of OLD is in NEW with the same instructions.  With
``--demangle`` kernels are matched by their demangled names (``cu++filt``)
without the parameter list and without spaces, so a kernel whose template
argument changed type or that gained a parameter is matched by a rename of
its template arguments alone.  Needs the CUDA toolkit's ``cuobjdump`` and
``cu++filt`` (next to ``nvcc``)."""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

_TAG = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def kernels(lib: Path, cuobjdump: str, strip: bool = True,
            addresses: bool = False):
    """{kernel name, tag stripped unless ``strip`` is false: [instruction,
    ...]} of a library; each instruction an (address, text) pair with
    ``addresses``."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if strip:
                name = _TAG.sub("_GLOBAL__N_", name)
            out[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2))
                                 if addresses else m.group(2))
    return out


def demangled(names, cufilt: str):
    """{mangled: demangled name without its parameter list or spaces}."""
    names = list(names)
    out = subprocess.run([cufilt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    short = {}
    for name, full in zip(names, out):
        depth, cut = 0, len(full)
        if full.endswith(")"):
            for i in range(len(full) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(full[i], 0)
                if depth == 0:
                    cut = i
                    break
        # an empty trailing parameter pack may print as a bare comma
        short[name] = re.sub(r",>", ">", re.sub(r"\s+", "", full[:cut])
                             ).removeprefix("void")
    return short


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--only", default="", help="kernels whose name holds it")
    ap.add_argument("--rename", nargs=2, action="append", default=[],
                    metavar=("REGEX", "REPL"))
    ap.add_argument("--demangle", action="store_true",
                    help="match by demangled names without parameters")
    args = ap.parse_args(argv)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    strip = not args.demangle   # demangled, the tags read "anonymous namespace"
    old, new = (kernels(lib, cuobjdump, strip) for lib in (args.old, args.new))
    if args.demangle:
        cufilt = str(Path(nvcc).parent / "cu++filt")
        old, new = ({demangled(lib, cufilt)[k]: v for k, v in lib.items()}
                    for lib in (old, new))
    ok = True
    for name, insns in old.items():
        if args.only not in name:
            continue
        target = name
        for regex, repl in args.rename:
            target = re.sub(regex, repl, target)
        if target not in new:
            base = target.split("<")[0]
            near = [n for n in new if n.split("<")[0] == base][:3]
            print(f"missing  {name} -> {target}"
                  + (f" (NEW has {', '.join(near)}, ...)" if near else ""))
            ok = False
        elif new[target] != insns:
            diff = sum(a != b for a, b in zip(insns, new[target]))
            print(f"differs  {target}: {len(insns)} -> {len(new[target])} "
                  f"instructions, {diff} differ in the common length")
            ok = False
        else:
            print(f"same     {target}: {len(insns)} instructions")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
