"""The kernel build's cache key: every source and header under ``csrc/``
and the flags name the library, so an edited header rebuilds.  Runs on the
CPU (nothing is compiled)."""

import pytest

from tensorflowonspark_torch.ops import cuda_build
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "common.cuh"\n')
    (src / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_unchanged_tree_reuses_the_build(csrc):
    first = cuda_build.library_path("kern")
    assert first == cuda_build.library_path("kern")
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("kern-")


@pytest.mark.parametrize("edit", ["header", "source", "new_header", "flags"])
def test_edit_changes_the_library_name(csrc, monkeypatch, edit):
    before = cuda_build.library_path("kern")
    if edit == "header":
        (csrc / "common.cuh").write_text("// v2\n")
    elif edit == "source":
        (csrc / "kern.cu").write_text('#include "common.cuh"\n// edited\n')
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("// new\n")
    else:
        monkeypatch.setattr(cuda_build, "NVCC_FLAGS", (*cuda_build.NVCC_FLAGS, "-lineinfo"))
    assert cuda_build.library_path("kern") != before


def test_other_files_do_not_change_the_library_name(csrc):
    before = cuda_build.library_path("kern")
    (csrc / "notes.txt").write_text("not compiled\n")
    assert cuda_build.library_path("kern") == before
