"""The port's four examples (``src/repro_torch/examples``) run on the CPU at
their smallest arguments and print what the reference's examples print.
One intra-op thread: ``train_lm``'s ~10M-parameter draw runs ~10x slower
on the default threads of a busy host."""
import math

import pytest
import torch

from repro_torch.examples import (fleet_allocation, quickstart, serve_llm,
                                  train_lm)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart(capsys):
    quickstart.main(["--device", "cpu", "--duration-s", "4"])
    out = capsys.readouterr().out
    for control in ("adaptbf", "static", "nobw"):
        assert f"\n{control:8s}  completion=" in out
    assert "busy-phase utilization=" in out and "expected:" in out


def test_fleet_allocation(capsys):
    fleet_allocation.main(["--device", "cpu", "--duration-s", "0.5",
                           "--osts", "8", "--jobs", "16"])
    out = capsys.readouterr().out
    assert "scenario fleet_noisy_neighbor" in out
    assert "AdapTBF cuts its take there" in out
    assert out.count("(= 8x20000: OK)") == 3


def test_serve_llm(capsys):
    done = serve_llm.main(["--device", "cpu", "--requests", "2",
                           "--max-new-tokens", "2"])
    assert len(done) == 2 and all(len(r.output) == 2 for r in done)
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "[interactive]" in out
    assert "AdapTBF admission windows run:" in out


def test_train_lm(capsys, tmp_path):
    hist = train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "1",
                          "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2
    assert all(math.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "model: train-lm-demo" in out and "final loss" in out
    assert "allocation windows ran" in out
