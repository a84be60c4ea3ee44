"""The kernel library's name follows every file the build reads.

``ops/_build.py`` loads a library named by a hash of the CUDA sources,
the headers they include and the flags; an edit to any of them must give a
new name, or a stale library would load.  Needs no ``nvcc``: only the name
is computed.
"""

import shutil

import pytest

from genpose_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the sources that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("name", ["fps_round.cuh", "fps.cu", "fps_bq_fused.cu", "score_head.cu",
                                  "sa_stage.cu"])
def test_an_edit_renames_the_library(csrc, name):
    before = _build.library_path()
    assert before == _build.library_path()  # the name is a function of the files
    path = csrc / name
    path.write_text(path.read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR


def test_a_new_header_renames_the_library(csrc):
    before = _build.library_path()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path() != before


def test_other_files_leave_the_name(csrc):
    before = _build.library_path()
    (csrc / "notes.txt").write_text("not read by nvcc\n")
    assert _build.library_path() == before
