"""The kernel build's cache key (``ops/kernels/build.library_path``): a
library is rebuilt when its source, a header beside it or the flags change,
and only then. No compiler is run."""

from osvos_torch.ops.kernels import build


def _csrc(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\nint k;\n')
    (csrc / "common.cuh").write_text("#pragma once\nconstexpr int kA = 1;\n")
    (csrc / "other.cuh").write_text("#pragma once\n")
    return csrc


def test_library_path_follows_the_source_and_every_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    first = build.library_path("k")
    assert first == build.library_path("k")  # the same bytes, the same key
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")

    (csrc / "common.cuh").write_text("#pragma once\nconstexpr int kA = 2;\n")
    second = build.library_path("k")
    assert second != first

    (csrc / "other.cuh").write_text("#pragma once\n// edited\n")
    third = build.library_path("k")
    assert third not in (first, second)

    (csrc / "k.cu").write_text('#include "common.cuh"\nint k2;\n')
    assert build.library_path("k") not in (first, second, third)


def test_library_path_follows_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", _csrc(tmp_path))
    first = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") != first


def test_the_port_sources_share_the_hopper_header():
    """wgrad.cu and flatconv.cu include csrc/hopper.cuh, so its bytes are
    in both libraries' keys."""
    for name in ("wgrad", "flatconv"):
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in src
    assert (build.CSRC_DIR / "hopper.cuh").exists()
