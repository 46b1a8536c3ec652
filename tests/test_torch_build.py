"""The port's kernel build helper: a library's name hashes its source,
the shared headers and the flags, so an edited header builds anew.  No
``nvcc`` is needed: only the names are computed."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\nint k;\n')
    (tmp_path / "hopper.cuh").write_text("#pragma once\n")
    return tmp_path


def test_target_changes_with_a_shared_header(csrc):
    first = _build._target("k")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
    assert _build._target("k") == first
    (csrc / "hopper.cuh").write_text("#pragma once\n// edited\n")
    second = _build._target("k")
    assert second != first
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert _build._target("k") != second


def test_target_changes_with_the_source_and_not_with_other_sources(csrc):
    first = _build._target("k")
    (csrc / "j.cu").write_text("int j;\n")
    assert _build._target("k") == first
    assert _build.sources() == ["j", "k"]
    (csrc / "k.cu").write_text('#include "hopper.cuh"\nint k2;\n')
    assert _build._target("k") != first


def test_the_shared_header_is_in_the_tree():
    assert (_build.CSRC / "hopper.cuh").is_file()
    assert "hopper.cuh" in (_build.CSRC / "flash_attention.cu").read_text()
    assert "hopper.cuh" in (_build.CSRC / "gla_scan.cu").read_text()
