"""The port's roofline (``launch/roofline.py``) against the reference's:
``analytic_cost`` and ``model_flops_for`` exactly equal for the ten full
configs, the four ``SHAPES`` cells and microbatches 1 and 4;
``roofline_terms``' time terms the reference's scaled by the ratios of the
two cards' constants (TPU v5e there, H100 SXM here), its other keys equal;
``collective_stats`` on the port's counters the reference's schema and
ring model, against the reference's reading of the same collectives
written as HLO."""
import pytest

from repro.configs import ARCHS, get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import roofline as jroof
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_equals_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name, cell in SHAPES.items():
        for micro in (1, 4):
            assert roofline.analytic_cost(cfg, cell, micro) == \
                jroof.analytic_cost(jcfg, JSHAPES[name], micro), (name, micro)
        assert roofline.model_flops_for(cfg, cell) == \
            jroof.model_flops_for(jcfg, JSHAPES[name])


def _counters(ar_bytes, ag_block, g):
    """The port's counters after one all-reduce of ``ar_bytes`` and one
    all-gather of a ``ag_block``-byte block over ``g`` ranks."""
    return {"all_reduce": {"calls": 1, "seconds": 0.0, "bytes": ar_bytes,
                           "ring_bytes": 2 * ar_bytes * (g - 1) / g},
            "all_gather": {"calls": 1, "seconds": 0.0, "bytes": ag_block,
                           "ring_bytes": ag_block * (g - 1)}}


def test_collective_stats_reads_the_counters_as_the_reference_reads_hlo():
    g, n = 4, 1024
    hlo = (f"ENTRY %main (p: f32[{n}]) -> f32[{n}] {{\n"
           f"  %ar = f32[{n}]{{0}} all-reduce(f32[{n}]{{0}} %p), "
           "replica_groups={{0,1,2,3}}\n"
           f"  %ag = f32[{n * g}]{{0}} all-gather(f32[{n}]{{0}} %ar), "
           "replica_groups={{0,1,2,3}}\n}\n")
    want = jroof.collective_stats(hlo)
    got = roofline.collective_stats(_counters(4 * n, 4 * n, g))
    assert got == want
    assert set(got["all-reduce"]) == {"count", "operand_bytes", "ring_bytes"}


def test_roofline_terms_scale_by_the_cards_constants():
    jcfg, cfg = jget_config("zamba2-2.7b"), get_config("zamba2-2.7b")
    cell = SHAPES["train_4k"]
    coll = roofline.collective_stats(_counters(1 << 20, 1 << 18, 2))
    args = (jroof.analytic_cost(jcfg, JSHAPES["train_4k"]), coll, 4,
            jroof.model_flops_for(jcfg, JSHAPES["train_4k"]), {"flops": 1.0})
    want = jroof.roofline_terms(*args)
    got = roofline.roofline_terms(
        roofline.analytic_cost(cfg, cell), coll, 4,
        roofline.model_flops_for(cfg, cell), {"flops": 1.0})
    assert sorted(got) == sorted(want)
    ratio = {"compute_s": jroof.PEAK_FLOPS / roofline.PEAK_FLOPS,
             "memory_s": jroof.HBM_BW / roofline.HBM_BW,
             "collective_s": jroof.LINK_BW / roofline.LINK_BW,
             "collective_ring_s": jroof.LINK_BW / roofline.LINK_BW}
    for k, v in want.items():
        if k in ratio:
            assert got[k] == pytest.approx(v * ratio[k], rel=1e-12), k
        elif k not in ("dominant", "roofline_fraction"):
            assert got[k] == v, k
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    bound = max(got["compute_s"], got["memory_s"], got["collective_ring_s"])
    assert got["roofline_fraction"] == got["compute_s"] / bound
