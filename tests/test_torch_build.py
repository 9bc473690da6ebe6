"""The port's kernel build (`repro_torch.kernels._build`): a library's
name is a hash of its source, every shared header under csrc/ and the
flags, so an edited header gives every library a new name and so a
rebuild (no nvcc needed: only the names are computed here)."""

import shutil

from repro_torch.kernels import _build


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert "sm90.cuh" in headers
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    before = {s: _build.library_path(s) for s in sources}
    assert before == {s: _build.library_path(s) for s in sources}  # stable
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build.library_path(s) for s in sources}
    assert all(after[s] != before[s] for s in sources)
    assert all(after[s].name.startswith(f"lib{s[:-3]}_") for s in sources)
    (csrc / "extra.cuh").write_text("#pragma once\n")     # a new header
    assert all(_build.library_path(s) != after[s] for s in sources)


def test_library_name_follows_source_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("flash.cu")
    other = _build.library_path("flash_bwd.cu")
    (csrc / "flash.cu").write_text((csrc / "flash.cu").read_text() + "\n")
    assert _build.library_path("flash.cu") != before
    assert _build.library_path("flash_bwd.cu") == other
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path("flash_bwd.cu") != other
