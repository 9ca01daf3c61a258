"""``tools/sass_census.py``, which counts the instructions of one tick of a
fleet kernel's tick loop by class from its SASS, on hand-written SASS of
the shape ``cuobjdump -sass`` prints (the tool itself runs where the CUDA
toolkit is): the loop with the most barriers is the tick loop, a tick
whose second row sum is skipped runs a path with one barrier fewer, and
each instruction falls in its class."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import sass_census  # noqa: E402

# a kernel with a setup loop (no barrier) and a tick loop whose second
# reduction sits behind a uniform branch
SASS = """
LDC R1, c[0x0][0x28]
S2R R0, SR_TID.X
ISETP.GE.AND P0, PT, R0, 0x10, PT
@!P0 BRA 0x20
F2F.F64.F32 R2, R4
DADD R2, R2, R6
SHFL.BFLY PT, R3, R2, 0x10, 0x1f
STS.64 [R5], R2
BAR.SYNC.DEFER_BLOCKING 0x0
LDS.64 R2, [R5]
FSETP.NEU.AND P1, PT, R7, 1, PT
@!P1 BRA 0x110
FMUL R8, R8, R7
F2F.F64.F32 R10, R8
DADD R12, R12, R10
SHFL.BFLY PT, R13, R12, 0x10, 0x1f
BAR.SYNC.DEFER_BLOCKING 0x0
FMNMX R9, R7, RZ, !PT
FADD R9, R9, -R7
STG.E [R14.64], R9
@P0 BRA 0x40
EXIT
BRA 0x160
"""


def _insns(text):
    return [(16 * k, line.strip()) for k, line in
            enumerate(x for x in text.splitlines() if x.strip())]


def test_census_picks_the_tick_loop_and_its_two_paths():
    [got] = sass_census.census(_insns(SASS))
    # the loop from 0x40 (the first F2F) to the branch back at 0x140
    assert sum(got["static"].values()) == 17
    paths = got["paths"]
    assert sorted(paths) == [1, 2]
    full, skip = paths[2], paths[1]
    assert (full["BAR"], full["F2F"], full["DADD"], full["SHFL"]) == (2, 2, 2, 2)
    assert (skip["BAR"], skip["F2F"], skip["DADD"], skip["SHFL"]) == (1, 1, 1, 1)
    assert sum(full.values()) == 17 and sum(skip.values()) == 12
    assert full["control"] == 2 and skip["control"] == 2


@pytest.mark.parametrize("text,klass", [
    ("F2F.F32.F64 R1, R2", "F2F"), ("DADD R2, R2, R4", "DADD"),
    ("SHFL.BFLY PT, R3, R2, 0x10, 0x1f", "SHFL"),
    ("BAR.SYNC.DEFER_BLOCKING 0x0", "BAR"), ("UCGABAR_WAIT", "BAR"),
    ("FMNMX R1, R2, R3, !PT", "FP32"), ("MUFU.RCP R1, R2", "FP32"),
    ("DSETP.GEU.AND P0, PT, R2, R4, PT", "FP64"),
    ("IADD3 R1, R2, 0x1, RZ", "ALU"), ("LOP3.LUT R1, R2, R3, RZ, 0xc0, !PT",
                                       "ALU"),
    ("LDG.E R1, [R2.64]", "load"), ("LDS.64 R2, [R5]", "load"),
    ("STG.E [R2.64], R1", "store"), ("BSSY B0, 0x300", "control"),
    ("@!P0 BRA 0x20", "control")])
def test_census_classes(text, klass):
    _, op, _ = sass_census.split(text)
    assert sass_census.klass(op) == klass


def test_census_reads_branches():
    assert sass_census.branch(*sass_census.split("@!P0 BRA 0x20")) == (0x20, True)
    assert sass_census.branch(*sass_census.split("BRA 0x110")) == (0x110, False)
    assert sass_census.branch(*sass_census.split("BRA.U !UP0, 0x80")) == (0x80, True)
    assert sass_census.branch(*sass_census.split("EXIT")) == (None, False)
    assert sass_census.branch(*sass_census.split("@P1 EXIT")) == (None, True)
    assert sass_census.branch(*sass_census.split("DADD R2, R2, R4")) is None


def test_census_reports_each_tick_loop():
    """A kernel with a tick loop for full blocks and one for ragged ones
    (each with its barrier) reports both, in address order."""
    lines = [line for line in SASS.splitlines() if line.strip()]
    body = lines[4:21]                    # the tick loop, 0x40 to 0x140
    second = [line.replace("0x40", "0x150").replace("0x110", "0x220")
              for line in body]           # the same at 0x150 to 0x250
    text = "\n".join(lines[:4] + body + second + ["EXIT", "BRA 0x270"])
    got = sass_census.census(_insns(text))
    assert len(got) == 2
    for loop in got:
        assert sum(loop["static"].values()) == 17
        assert sorted(loop["paths"]) == [1, 2]
