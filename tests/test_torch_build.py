"""The name of a kernel's built library follows its source and the headers
it includes (``kernels/build.py::build_tag``): an edited header never
loads a stale build.  No ``nvcc`` is needed: only the hash is computed."""

import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import build

CSRC = Path(build.__file__).resolve().parent / "csrc"


@pytest.fixture
def csrc(tmp_path):
    """A copy of the package's sources plus a small tree of its own:
    top.cu includes mid.cuh, which includes leaf.cuh; lone.cu includes
    nothing."""
    d = tmp_path / "csrc"
    shutil.copytree(CSRC, d)
    (d / "leaf.cuh").write_text("#pragma once\nconstexpr int LEAF = 1;\n")
    (d / "mid.cuh").write_text('#pragma once\n#include "leaf.cuh"\n')
    (d / "top.cu").write_text('#include <cuda_runtime.h>\n'
                              '  #  include "mid.cuh"\nint top() {}\n')
    (d / "lone.cu").write_text("int lone() { return 0; }\n")
    return d


def _tags(d):
    return {p.name: build.build_tag(p.name, d) for p in d.glob("*.cu")}


def test_tag_is_stable_and_matches_the_package(csrc):
    assert _tags(csrc) == _tags(csrc)
    for name in ("gemm_pe.cu", "flash_attention.cu", "sim_step.cu"):
        assert build.build_tag(name, csrc) == build.build_tag(name)


@pytest.mark.parametrize("header,changed", [
    ("leaf.cuh", {"top.cu"}), ("mid.cuh", {"top.cu"}),
    ("hopper.cuh", {"gemm_pe.cu", "flash_attention.cu"})])
def test_tag_changes_with_included_headers_only(csrc, header, changed):
    before = _tags(csrc)
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = _tags(csrc)
    assert {n for n in before if before[n] != after[n]} == changed


def test_tag_changes_with_the_source_and_flags(csrc, monkeypatch):
    before = _tags(csrc)
    (csrc / "lone.cu").write_text("int lone() { return 1; }\n")
    after = _tags(csrc)
    assert {n for n in before if before[n] != after[n]} == {"lone.cu"}
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    flagged = _tags(csrc)
    assert all(flagged[n] != after[n] for n in after)


def test_unrelated_header_and_system_includes_change_nothing(csrc):
    before = _tags(csrc)
    (csrc / "unused.cuh").write_text("#pragma once\n")
    assert _tags(csrc) == before
