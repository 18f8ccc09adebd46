"""The port's kernel build flags, without nvcc: each source's own flags,
a library path that follows them, and one compile where several
processes build a source at once."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402
from repro_torch.kernels.hdp_z import hdp_z as HZ  # noqa: E402
from repro_torch.kernels.ssd import ssd as SSD  # noqa: E402


def test_hdp_z_builds_without_contraction():
    flags = _build.nvcc_flags(HZ.SOURCE)
    assert "--fmad=false" in flags and "--fmad=true" not in flags
    assert "--use_fast_math" not in flags


def test_the_lanes_hdp_z_kernel_builds_without_contraction():
    assert HZ.LANES_SOURCE.name == "hdp_z_lanes.cu"
    flags = _build.nvcc_flags(HZ.LANES_SOURCE)
    assert "--fmad=false" in flags and "--fmad=true" not in flags
    assert "--use_fast_math" not in flags
    assert set(HZ.SOURCES) == {HZ.SOURCE, HZ.LANES_SOURCE}


@pytest.mark.parametrize("source", [*HZ.SOURCES, *FA.SOURCES, *SSD.SOURCES],
                         ids=lambda p: p.name)
def test_every_build_targets_sm90a_and_keeps_the_ptxas_report(source):
    flags = _build.nvcc_flags(source)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert flags[flags.index("-Xptxas") + 1] == "-v"
    assert sum(f.startswith("--fmad=") for f in flags) == 1


def test_the_tensor_core_flash_kernel_contracts():
    assert "--fmad=true" in _build.nvcc_flags(FA.SM90_SOURCE)


def test_the_tensor_core_ssd_kernel_contracts_and_is_built_beside_the_other():
    assert SSD.SM90_SOURCE.name == "ssd_chunk_sm90.cu"
    assert _build.SOURCE_FLAGS["ssd_chunk_sm90.cu"] == ("--fmad=true",)
    flags = _build.nvcc_flags(SSD.SM90_SOURCE)
    assert "--fmad=true" in flags and "--use_fast_math" not in flags
    # the CUDA-core kernel keeps the flags it was measured with
    assert "--fmad=false" in _build.nvcc_flags(SSD.SOURCE)
    assert SSD.SOURCES == (SSD.SOURCE, SSD.SM90_SOURCE, SSD.WIDE_SOURCE)
    assert all(src.exists() for src in SSD.SOURCES)


def test_the_wide_ssd_kernel_contracts_and_is_built_beside_the_others():
    assert SSD.WIDE_SOURCE.name == "ssd_chunk_sm90_wide.cu"
    assert _build.SOURCE_FLAGS["ssd_chunk_sm90_wide.cu"] == ("--fmad=true",)
    flags = _build.nvcc_flags(SSD.WIDE_SOURCE)
    assert "--fmad=true" in flags and "--use_fast_math" not in flags
    assert len(set(map(_build.library_path, SSD.SOURCES))) == len(SSD.SOURCES)


def test_a_change_of_flags_changes_the_library_path(monkeypatch):
    own = {src: _build.library_path(src) for src in (FA.SM90_SOURCE, HZ.SOURCE)}
    assert own[FA.SM90_SOURCE] == _build.library_path(FA.SM90_SOURCE)
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {
        **_build.SOURCE_FLAGS, FA.SM90_SOURCE.name: ("--fmad=false",),
        HZ.SOURCE.name: ("--fmad=true",)})
    assert "--fmad=false" in _build.nvcc_flags(FA.SM90_SOURCE)
    for src, path in own.items():
        assert _build.library_path(src) != path


def test_the_report_is_read_from_beside_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.ptxas_report(FA.SM90_SOURCE) == ""
    lib = _build.library_path(FA.SM90_SOURCE)
    assert lib.parent == tmp_path
    lib.with_suffix(".ptxas.txt").write_text("ptxas info : Used 96 registers\n")
    assert "96 registers" in _build.ptxas_report(FA.SM90_SOURCE)


def test_the_lanes_ablation_patches_apply(tmp_path, monkeypatch):
    from repro_torch.launch import ablate_hdp_z as A

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    sources = A.patched_sources()
    assert set(sources) == {"kernel", *A.PATCHES}
    text = HZ.LANES_SOURCE.read_text()
    for name, path in sources.items():
        assert path.name == HZ.LANES_SOURCE.name
        assert (path.read_text() == text) == (name == "kernel")
        assert _build.nvcc_flags(path) == _build.nvcc_flags(HZ.LANES_SOURCE)


def test_the_ssd_ablation_patches_apply(tmp_path, monkeypatch):
    from repro_torch.launch import ablate_ssd as A

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    sources = A.patched_sources()
    assert set(sources) == {"kernel", *A.PATCHES}
    assert set(A.HELD) == set(sources) - {"one_pass"}
    text = SSD.SM90_SOURCE.read_text()
    for name, path in sources.items():
        assert path.name == SSD.SM90_SOURCE.name
        assert (path.read_text() == text) == (name == "kernel")
        assert _build.nvcc_flags(path) == _build.nvcc_flags(SSD.SM90_SOURCE)


def test_the_wide_ssd_ablation_patches_apply(tmp_path, monkeypatch):
    from repro_torch.launch import ablate_ssd as A

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    kernel = A.KERNELS["mamba2"]
    sources = A.patched_sources(kernel)
    assert set(sources) == {"kernel", *A.WIDE_PATCHES}
    assert set(kernel.held) == set(sources) - {"one_pass", "rounded_lo"}
    text = SSD.WIDE_SOURCE.read_text()
    for name, path in sources.items():
        assert path.name == SSD.WIDE_SOURCE.name
        assert (path.read_text() == text) == (name == "kernel")
        assert _build.nvcc_flags(path) == _build.nvcc_flags(SSD.WIDE_SOURCE)
        assert path.parent.parent.name == ("ssd" if name == "kernel" else "ablate_ssd_wide")


def test_ranks_that_build_together_compile_once(tmp_path, monkeypatch):
    """The ranks of a sharded run reach one build together: the lock
    beside the library lets one compile and the others load its result."""
    import threading

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        "sleep 0.3\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(_build.build(HZ.SOURCE)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(outs) == 4 and len(set(outs)) == 1 and outs[0].read_text() == "lib\n"
    assert calls.read_text().count("x") == 1
