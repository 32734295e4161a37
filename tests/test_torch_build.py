"""The port's kernel builder (``repro_torch.kernels._build``) on the CPU:
the ``nvcc`` command line each source gets and the library path it is
loaded from, with ``subprocess.run`` and the dynamic loader patched."""
import subprocess
from pathlib import Path
from unittest import mock

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.flashattn import kernel as flashattn
from repro_torch.kernels.frontier import kernel as frontier
from repro_torch.kernels.segsum import kernel as segsum
from repro_torch.kernels.stopcheck import kernel as stopcheck


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """Every command ``subprocess.run`` received and every path the
    loader opened; the fake nvcc writes its ``-o`` file, or fails when
    the command names a source called ``bad.cu``."""
    seen = {"commands": [], "loaded": []}

    def run(cmd, capture_output, text):
        seen["commands"].append(list(cmd))
        if any(arg.endswith("bad.cu") for arg in cmd):
            return subprocess.CompletedProcess(cmd, 1, "", "error")
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    def cdll(path):
        seen["loaded"].append(path)
        return mock.MagicMock()     # takes the argtypes declare() sets

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_REPORTS", {})
    return seen


def test_common_flags_are_unchanged():
    assert _build.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@pytest.mark.parametrize("module", [frontier, stopcheck, segsum],
                         ids=["frontier", "stopcheck", "segsum"])
def test_sources_without_extra_flags_keep_their_command(nvcc, module):
    """nvcc, the common flags, ``-o`` a temporary file, the source:
    nothing else."""
    module.library()
    (cmd,) = nvcc["commands"]
    assert cmd[:-3] == ["/cuda/bin/nvcc", *_build.NVCC_FLAGS]
    assert cmd[-3] == "-o" and cmd[-2].endswith(".so")
    assert cmd[-1] == str(module.SOURCE)


def test_extra_flags_follow_the_source(nvcc):
    flashattn.library()
    (cmd,) = nvcc["commands"]
    assert flashattn.EXTRA_FLAGS == ("-lcuda",)
    assert cmd[:-4] == ["/cuda/bin/nvcc", *_build.NVCC_FLAGS]
    assert cmd[-4] == "-o" and cmd[-2:] == [str(flashattn.SOURCE), "-lcuda"]
    report = _build.build_report("flashattn")
    assert report["path"] == nvcc["loaded"][0]
    assert report["ptxas"] == "ptxas info"


def test_the_backward_links_the_driver_api_too(nvcc):
    """K5 bwd's bfloat16 route encodes TMA tensor maps
    (``cuTensorMapEncodeTiled``), so its library takes the forward's
    extra flags after its source."""
    flashattn.bwd_library()
    (cmd,) = nvcc["commands"]
    assert cmd[:-4] == ["/cuda/bin/nvcc", *_build.NVCC_FLAGS]
    assert cmd[-4] == "-o"
    assert cmd[-2:] == [str(flashattn.BWD_SOURCE), *flashattn.EXTRA_FLAGS]
    assert _build.build_report("flashattn_bwd")["path"] == nvcc["loaded"][0]


def test_both_flash_sources_include_the_shared_header():
    """The forward and the backward take their PTX helpers from the one
    header beside them, which the build's digest covers."""
    header = flashattn.SOURCE.with_name("sm90.cuh")
    assert header.exists()
    for source in (flashattn.SOURCE, flashattn.BWD_SOURCE):
        assert '#include "sm90.cuh"' in source.read_text()


def test_a_changed_header_gets_a_new_library(nvcc, tmp_path, monkeypatch):
    """A header (``*.cuh``) beside the source is part of the digest: an
    edit to it alone builds and loads another library."""
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    _build.load("k", src, lambda lib: None)
    header.write_text("// two\n")
    monkeypatch.setattr(_build, "_LOADED", {})         # a new process
    _build.load("k", src, lambda lib: None)
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "_LOADED", {})
    _build.load("k", src, lambda lib: None)
    first, edited, again = nvcc["loaded"]
    assert len(nvcc["commands"]) == 2
    assert edited != first and again == first


def test_a_rebuild_never_loads_a_stale_library(nvcc, tmp_path, monkeypatch):
    """Another flag set or another source text gets another library
    path (the loader hands back the library it already holds for a path
    it has opened); the same ones get the same path, which a new process
    loads without building again."""
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    _build.load("k", src, lambda lib: None)
    _build.load("k", src, lambda lib: None)            # built once
    _build.load("k", src, lambda lib: None, ("-lcuda",))
    src.write_text("// two\n")
    monkeypatch.setattr(_build, "_LOADED", {})         # a new process
    _build.load("k", src, lambda lib: None)
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "_LOADED", {})
    _build.load("k", src, lambda lib: None)
    first, flagged, edited, again = nvcc["loaded"]
    assert len(nvcc["commands"]) == 3
    assert len({first, flagged, edited}) == 3 and again == first
    assert all(Path(p).parent == tmp_path and Path(p).name.startswith("k-")
               for p in nvcc["loaded"])
    # the temporary outputs were renamed, none is left behind
    assert sorted(p.name for p in tmp_path.glob("*.so")) == sorted(
        {Path(p).name for p in nvcc["loaded"]})


def test_a_refused_source_raises_and_leaves_nothing(nvcc, tmp_path):
    bad = tmp_path / "bad.cu"
    bad.write_text("not cuda\n")
    with pytest.raises(_build.KernelBuildError, match="nvcc exit 1"):
        _build.load("bad", bad, lambda lib: None)
    assert not list(tmp_path.glob("*.so")) and not nvcc["loaded"]


def test_a_library_built_by_another_process_is_loaded_without_nvcc(
        nvcc, tmp_path, monkeypatch):
    """The ranks of a spawned group load what their parent built: same
    path, no command, and the build's ptxas report read back."""
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    _build.load("k", src, lambda lib: None)
    built = _build.build_report("k")
    monkeypatch.setattr(_build, "_LOADED", {})         # another process
    monkeypatch.setattr(_build, "_REPORTS", {})
    _build.load("k", src, lambda lib: None)
    assert len(nvcc["commands"]) == 1
    assert nvcc["loaded"] == [built["path"]] * 2
    again = _build.build_report("k")
    assert again["ptxas"] == built["ptxas"] == "ptxas info"
    assert again["seconds"] == 0.0 and again["path"] == built["path"]
