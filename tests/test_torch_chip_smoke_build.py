"""``chip_smoke.build_all``'s gate on the kernels' ptxas lines, with the
compiler replaced by a stub that returns chosen ``-Xptxas -v`` output (no
``nvcc`` here): a freshly built library is checked on its own output; an
up-to-date one on the saved log of the build that made it; one whose
saved log has no ptxas lines is rebuilt with ``-v``; and the gate fails
on a stack frame or spill, and where no ptxas lines can be had at all.
The inter tool kernels' sources (warp, comp, obmc) are built and gated
like the others.
``cuda_build.build_variants`` (a tool's timing builds) builds a source
once a tag with its macros, through the same stub. Tolerance: exact (pass or fail)."""
import pytest

import chip_smoke
from dav1d_mirror_tpu_torch.ops import cuda_build


def _ptxas(name, frame=0):
    return (f"ptxas info    : Compiling entry function '{name}_k' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}_k\n"
            f"    {frame} bytes stack frame, 0 bytes spill stores, 0 bytes "
            f"spill loads\nptxas info    : Used 40 registers\n")


def _stub(monkeypatch, tmp_path, fresh, saved, rebuilt):
    """cuda_build.build builds `fresh` ({name: output}) and, when forced,
    returns `rebuilt`'s output; `saved` {name: text} are the saved logs
    of the libraries already built. Returns the force lists asked for."""
    forced = []
    for name, text in saved.items():
        (tmp_path / f"lib{name}.log").write_text(text)

    def build(flags=(), force=()):
        assert list(flags) == ["-Xptxas", "-v"]
        if force:
            forced.append(list(force))
            return {n: rebuilt[n] for n in force}
        return dict(fresh)
    monkeypatch.setattr(cuda_build, "build", build)
    monkeypatch.setattr(cuda_build, "log_path",
                        lambda name: str(tmp_path / f"lib{name}.log"))
    return forced


def test_fresh_and_saved_logs_are_checked(monkeypatch, tmp_path):
    names = sorted(chip_smoke.NO_SPILL)
    forced = _stub(monkeypatch, tmp_path, {names[0]: _ptxas(names[0])},
                   {n: _ptxas(n) for n in names[1:]}, {})
    chip_smoke.build_all()
    assert forced == []


def test_saved_log_without_ptxas_lines_is_rebuilt(monkeypatch, tmp_path):
    names = sorted(chip_smoke.NO_SPILL)
    forced = _stub(monkeypatch, tmp_path, {},
                   {n: "" if n == "deblock" else _ptxas(n) for n in names},
                   {"deblock": _ptxas("deblock")})
    chip_smoke.build_all()
    assert forced == [["deblock"]]


@pytest.mark.parametrize("where", ["fresh", "saved", "rebuilt"])
def test_stack_frame_fails(monkeypatch, tmp_path, where):
    names = sorted(chip_smoke.NO_SPILL)
    bad = {"cdef": _ptxas("cdef", frame=16)}
    fresh = bad if where == "fresh" else {}
    saved = {n: _ptxas(n) for n in names if n not in fresh}
    if where != "fresh":
        saved["cdef"] = bad["cdef"] if where == "saved" else ""
    _stub(monkeypatch, tmp_path, fresh, saved, bad)
    with pytest.raises(AssertionError, match="stack frame or spills"):
        chip_smoke.build_all()


@pytest.mark.parametrize("name", ["warp", "comp", "obmc"])
def test_tool_kernels_are_built_and_gated(monkeypatch, tmp_path, name):
    """Each inter tool kernel's source is one of cuda_build.SOURCES (so it
    is built at first use) and of the gate's NO_SPILL set: a spill in its
    fresh build fails the gate, and a clean one passes."""
    assert name in cuda_build.SOURCES and name in chip_smoke.NO_SPILL
    names = sorted(chip_smoke.NO_SPILL)
    spill = _ptxas(name).replace("0 bytes spill stores",
                                 "8 bytes spill stores")
    _stub(monkeypatch, tmp_path, {name: spill},
          {n: _ptxas(n) for n in names if n != name}, {})
    with pytest.raises(AssertionError, match="stack frame or spills"):
        chip_smoke.build_all()
    _stub(monkeypatch, tmp_path, {name: _ptxas(name)},
          {n: _ptxas(n) for n in names if n != name}, {})
    chip_smoke.build_all()


def test_no_ptxas_lines_fails(monkeypatch, tmp_path):
    """A library cached with no saved log whose rebuild prints no ptxas
    lines (the compiler run without -v) fails the gate."""
    names = sorted(chip_smoke.NO_SPILL)
    _stub(monkeypatch, tmp_path, {},
          {n: _ptxas(n) for n in names if n != "itx"}, {"itx": ""})
    with pytest.raises(AssertionError, match="no ptxas lines"):
        chip_smoke.build_all()


def test_build_variants_defines_each_tag(monkeypatch, tmp_path):
    """cuda_build.build_variants compiles one source once a tag, with
    that tag's macros defined, into lib<name>_<tag>.so; a failed build
    raises."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nfor a; do case "$prev" in -o) out=$a;; '
                    'esac; prev=$a; done\necho "$@" > "$out"\n'
                    'case "$*" in *-DFAIL*) exit 1;; esac\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD", str(tmp_path / "kernels"))
    paths = cuda_build.build_variants("cdef", {"a": (), "b": ("X", "Y")})
    assert sorted(paths) == ["a", "b"]
    for tag, want in (("a", []), ("b", ["-DX", "-DY"])):
        assert paths[tag].endswith(f"libcdef_{tag}.so")
        argv = open(paths[tag]).read().split()
        assert [f for f in argv if f.startswith("-D")] == want
        assert argv[-1].endswith("cdef.cu")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build_variants("cdef", {"c": ("FAIL",)})
