"""The port's kernel build names each library by a hash of its source, every
shared header in csrc/ and the flags: editing only a header makes a new
library name (so a stale library is never loaded), an unrelated file does not.
Needs no nvcc: only the names are computed."""

from greedy_multimodal_learning_tpu_torch.ops import build


def test_editing_only_a_shared_header_changes_the_library(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\nconstexpr int kTile = 8;\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("kern")
    assert before.parent == build.BUILD_DIR and before.name.startswith("libkern-")

    (tmp_path / "notes.txt").write_text("not a source")
    (tmp_path / "other.cc").write_text("int x;")
    assert build.library_path("kern") == before

    (tmp_path / "shared.cuh").write_text("#pragma once\nconstexpr int kTile = 16;\n")
    after = build.library_path("kern")
    assert after != before

    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("kern") != after


def test_editing_the_source_changes_the_library(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text("__global__ void k() {}\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("kern")
    (tmp_path / "kern.cu").write_text("__global__ void k() { }\n")
    assert build.library_path("kern") != before
