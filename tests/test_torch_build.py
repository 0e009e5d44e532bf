"""The port's kernel build (``ops/_build.py``) on the CPU, no ``nvcc``: a
library's path hashes its source and every header the source includes, so
an edited shared header rebuilds each library that includes it, and only
those."""

import shutil

import pytest

from k8s_dra_driver_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A scratch ``csrc/``: a.cu includes h.cuh, which includes g.cuh;
    b.cu includes nothing of it."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "h.cuh"\nint a() { return h(); }\n')
    (src / "b.cu").write_text("#include <stdint.h>\nint b() { return 1; }\n")
    (src / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\n'
                               "inline int h() { return g(); }\n")
    (src / "g.cuh").write_text("#pragma once\ninline int g() { return 2; }\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_source_files_follow_quoted_includes(csrc):
    assert [p.name for p in _build.source_files("a")] == [
        "a.cu", "h.cuh", "g.cuh"]
    assert [p.name for p in _build.source_files("b")] == ["b.cu"]


def test_library_path_is_stable_when_nothing_changes(csrc):
    first = {n: _build.library_path(n) for n in ("a", "b")}
    assert {n: _build.library_path(n) for n in ("a", "b")} == first
    assert first["a"].parent == csrc.parent / "build"
    assert first["a"].name.startswith("a-") and first["a"].suffix == ".so"


@pytest.mark.parametrize("header", ["h.cuh", "g.cuh"])
def test_editing_a_header_changes_only_its_includers(csrc, header):
    before = {n: _build.library_path(n) for n in ("a", "b")}
    path = csrc / header
    path.write_text(path.read_text() + "// edited\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    assert after["b"] == before["b"]


def _edited(tmp_path, monkeypatch, header):
    """On a copy of the real ``csrc/``: the libraries whose path changes
    when ``header`` is edited."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    names = _build.sources()
    before = {n: _build.library_path(n) for n in names}
    (src / header).write_text((src / header).read_text() + "// edited\n")
    return {n for n in names if _build.library_path(n) != before[n]}


def test_editing_hopper_header_changes_both_dependent_libraries(
        tmp_path, monkeypatch):
    """``hopper.cuh`` feeds the flash attention, grouped matmul and int8
    matmul libraries, the paged attention library through
    ``attention_tile.cuh`` and the MoE dispatch and int8 grouped matmul
    libraries through ``grouped_gemm.cuh``; every library."""
    assert _edited(tmp_path, monkeypatch, "hopper.cuh") == {
        "flash_attention", "grouped_matmul", "grouped_matmul_int8",
        "moe_dispatch", "paged_attention", "quant_matmul"}


def test_editing_grouped_gemm_header_changes_the_grouped_libraries(
        tmp_path, monkeypatch):
    """``grouped_gemm.cuh`` (the warp-specialised grouped GEMM pieces)
    feeds K10's library, K7/K8's wide body and A7b's, and no other."""
    assert _edited(tmp_path, monkeypatch, "grouped_gemm.cuh") == {
        "grouped_matmul", "grouped_matmul_int8", "moe_dispatch"}


def test_editing_int8_image_header_changes_the_int8_wgmma_libraries(
        tmp_path, monkeypatch):
    """``int8_image.cuh`` (int8 tiles into bf16 wgmma images) feeds
    ``int8_matmul``'s library, K7/K8's and A7b's, and no other."""
    assert _edited(tmp_path, monkeypatch, "int8_image.cuh") == {
        "grouped_matmul_int8", "moe_dispatch", "quant_matmul"}


def test_editing_attention_tile_header_changes_the_attention_libraries(
        tmp_path, monkeypatch):
    """``attention_tile.cuh`` (K4's tile step, shared with K3) feeds the
    flash and paged attention libraries, and no other."""
    assert _edited(tmp_path, monkeypatch, "attention_tile.cuh") == {
        "flash_attention", "paged_attention"}


def test_the_standalone_sources_include_no_header():
    """``rmsnorm.cu`` (K1 and its gradient) and ``ring_permute.cu`` (K9)
    include no header of ``csrc/``: no header edit renames their
    libraries, and ``rmsnorm.cu`` is one of the sources a build takes."""
    for name in ("rmsnorm", "ring_permute"):
        assert [p.name for p in _build.source_files(name)] == [f"{name}.cu"]
    assert "rmsnorm" in _build.sources()
