"""The port's kernel build cache key (megatronapp_tpu_torch/ops/cuda/build.py).

A library is reused only while its name's hash still matches what nvcc
would compile: the source, every header under csrc/ that a source may
include, and the flags. Nothing here runs nvcc.
"""

import os

import pytest

from megatronapp_tpu_torch.ops.cuda import build as kbuild


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("// helpers v1\n")
    (tmp_path / "notes.txt").write_text("not compiled\n")
    monkeypatch.setattr(kbuild, "CSRC", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("edit,changes", [
    ("helpers.cuh", True),      # an included header
    ("other.h", True),          # a new header under csrc/
    ("kernel.cu", True),        # the source itself
    ("notes.txt", False),       # not a source or header
])
def test_library_path_follows_sources_and_headers(csrc, edit, changes):
    src = str(csrc / "kernel.cu")
    before = kbuild.library_path(src)
    assert kbuild.library_path(src) == before
    with open(csrc / edit, "a") as f:
        f.write("// edited\n")
    after = kbuild.library_path(src)
    assert (after != before) == changes
    assert os.path.basename(after).startswith("kernel-")


def test_library_path_follows_the_flags(csrc, monkeypatch):
    src = str(csrc / "kernel.cu")
    before = kbuild.library_path(src)
    monkeypatch.setattr(kbuild, "NVCC_FLAGS", kbuild.NVCC_FLAGS + ["-G"])
    assert kbuild.library_path(src) != before
