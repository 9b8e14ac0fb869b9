"""The kernel build's cache key (seldon_core_tpu_torch/ops/_build.py): a
library's name hashes its source, the local headers that source includes
(transitively) and the nvcc flags — and nothing else, so an edited header
rebuilds only the sources that include it. No nvcc here: only the paths
are computed."""

import pytest

from seldon_core_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n  # include "h.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cstdint>\nint b;\n")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_hash_covers_the_local_headers_a_source_includes(csrc):
    assert [p.name for p in _build._with_headers(csrc / "a.cu", {})] == ["a.cu", "h.cuh",
                                                                       "g.cuh"]
    assert [p.name for p in _build._with_headers(csrc / "b.cu", {})] == ["b.cu"]


@pytest.mark.parametrize("edited,rebuilt", [
    ("g.cuh", {"a"}),        # a header two includes deep
    ("h.cuh", {"a"}),
    ("b.cu", {"b"}),         # a source alone
    ("a.cu", {"a"}),
])
def test_an_edit_rebuilds_only_what_includes_it(csrc, edited, rebuilt):
    before = {n: _build._library_path(n) for n in ("a", "b")}
    assert before == {n: _build._library_path(n) for n in ("a", "b")}   # stable
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    after = {n: _build._library_path(n) for n in ("a", "b")}
    assert {n for n in before if before[n] != after[n]} == rebuilt


def test_the_flags_count(csrc, monkeypatch):
    before = _build._library_path("b")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._library_path("b") != before


@pytest.mark.parametrize("name,headers", [
    ("fused_norm", []),
    ("fused_resnet_wgmma", ["hopper_wgmma.cuh"]),
    ("int8_matmul_wgmma", ["hopper_wgmma.cuh"]),
    ("int8_matmul", []),
    ("paged_attention", []),
])
def test_the_port_sources_hash_their_own_headers(name, headers):
    parts = _build._with_headers(_build.CSRC / f"{name}.cu", {})
    assert [p.name for p in parts] == [f"{name}.cu"] + headers
