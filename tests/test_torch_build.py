"""The CUDA build (``repro_torch.kernels._build``) without a GPU toolkit:
a missing ``nvcc`` raises and never falls back to a plain version, and the
library name is keyed by sources and flags so an edit rebuilds."""
import pytest

from repro_torch.kernels import _build


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["fleet_window", "adaptbf_alloc"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.launch("fleet_window", [])
    assert not list(tmp_path.iterdir())


def test_library_key_follows_sources_and_flags(monkeypatch, tmp_path):
    a = _build.library_path("fleet_window")
    assert a.parent == _build.BUILD_DIR
    assert a != _build.library_path("adaptbf_alloc")
    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ("-DPROBE",))
    assert _build.library_path("fleet_window") != a
    monkeypatch.undo()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path("fleet_window").name == a.name
    (csrc / "common.cuh").write_text("// edited\n")
    assert _build.library_path("fleet_window").name != a.name
