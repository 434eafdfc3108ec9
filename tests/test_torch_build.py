"""The kernel build's cache key, on the CPU (no nvcc needed).

``build.digest(name)`` names the library ``csrc/<name>.cu`` compiles to.  It
must change with the source, with every header under ``csrc/`` that the
source names with ``#include "..."`` (directly or through another header),
and with the flags; and it must not change with a file the source does not
include, or a stale library would be reused, or a fresh one rebuilt for
nothing.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                                   "int f() { return g(); }\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    "inline int g() { return h(); }\n")
    (tmp_path / "b.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("inline int u() { return 2; }\n")
    return tmp_path


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_digest_follows_the_source_and_its_headers(csrc, edited):
    before = build.digest("k")
    assert build.digest("k") == before
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert build.digest("k") != before


def test_digest_ignores_files_the_source_does_not_include(csrc):
    before = build.digest("k")
    (csrc / "other.cuh").write_text("inline int u() { return 3; }\n")
    (csrc / "new.cuh").write_text("inline int v() { return 4; }\n")
    assert build.digest("k") == before


def test_digest_follows_the_flags(csrc, monkeypatch):
    before = build.digest("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.digest("k") != before


def test_every_port_source_names_only_headers_that_exist():
    for src in sorted(build.CSRC.glob("*.cu")):
        for inc in build._INCLUDE.findall(src.read_bytes()):
            assert (src.parent / inc.decode()).is_file(), (src.name, inc)
