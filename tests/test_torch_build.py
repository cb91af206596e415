"""The kernel builder's cache key, on the CPU (nothing is compiled).

A library's file name carries a hash of its source, of every header the
source includes from ``csrc/`` and of the nvcc flags: an edited shared
header must give a new library path, or a stale library would load."""

import pytest

from ray_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text(
        '#include <stdint.h>\n#include "shared.cuh"\nint k;\n')
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "deep.cuh"\n')
    (tmp_path / "deep.cuh").write_text("// v1\n")
    (tmp_path / "unused.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited", ["kernel.cu", "shared.cuh", "deep.cuh"])
def test_editing_the_source_or_a_header_changes_the_library(csrc, edited):
    _, before = _build._paths("kernel.cu")
    path = csrc / edited
    path.write_text(path.read_text() + "// edit\n")
    _, after = _build._paths("kernel.cu")
    assert after != before
    assert after.name.startswith("kernel-") and after.suffix == ".so"


def test_a_header_the_source_does_not_include_does_not_count(csrc):
    _, before = _build._paths("kernel.cu")
    (csrc / "unused.cuh").write_text("// v2\n")
    assert _build._paths("kernel.cu")[1] == before


def test_flags_change_the_library(csrc, monkeypatch):
    _, before = _build._paths("kernel.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._paths("kernel.cu")[1] != before


@pytest.mark.parametrize("source,headers", [
    ("paged_attention.cu", ["mma_sm80.cuh"]),
    ("flash_attention.cu", ["mma_sm80.cuh"]),
    ("flash_fwd_sm90.cu", ["sm90.cuh"]),
    ("flash_bwd_sm90.cu", ["sm90.cuh"]),
])
def test_the_ports_sources_hash_their_shared_header(source, headers):
    names = [p.name for p in _build._sources_of(_build.CSRC / source)]
    assert names == [source] + headers


def test_editing_the_sm90_header_rebuilds_both_wgmma_libraries(
        tmp_path, monkeypatch):
    """The forward and the backward share ``sm90.cuh``: an edit there
    gives both a new library, and leaves the mma.sync sources alone."""
    for path in _build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    sources = ("flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
               "flash_attention.cu", "paged_attention.cu")
    before = {s: _build._paths(s)[1] for s in sources}
    header = tmp_path / "sm90.cuh"
    header.write_text(header.read_text() + "// edit\n")
    after = {s: _build._paths(s)[1] for s in sources}
    assert [after[s] != before[s] for s in sources] == [True, True, False,
                                                         False]
