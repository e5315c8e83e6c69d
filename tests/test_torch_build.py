"""The port's kernel build settings (``repro_torch.kernels._build``): which
sources keep ``--fmad=false``, and that each library's build key follows
its own flags only.  Nothing here runs nvcc."""

import pytest

from repro_torch.kernels import _build

# Held bit for bit (fused_reuse, reuse_snap) or to one output ulp (adaln)
# against their plain versions: every mul+add must round separately.
BIT_EQUAL = ("fused_reuse", "reuse_snap", "adaln")


def test_every_source_exists_and_builds_for_hopper():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        flags = _build.nvcc_flags(name)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "-shared" in flags and "-v" in flags


@pytest.mark.parametrize("name", BIT_EQUAL)
def test_bit_equal_sources_keep_fmad_off(name):
    assert "--fmad=false" in _build.nvcc_flags(name)


def test_ripple_builds_with_fused_multiply_adds():
    assert "--fmad=false" not in _build.nvcc_flags("ripple_attention")
    assert not any(f.startswith("-l") for f in
                   _build.nvcc_flags("ripple_attention"))


@pytest.mark.parametrize("name", _build.SOURCES)
def test_one_sources_flags_move_only_its_library(monkeypatch, name):
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    flags = dict(_build.SOURCE_FLAGS)
    flags[name] = flags.get(name, ()) + ("-lineinfo",)
    monkeypatch.setattr(_build, "SOURCE_FLAGS", flags)
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if before[n] != after[n]] == [name]



# Each source's own flags, as _build.py's comment documents them: the
# bit-equal sources and sparse keep --fmad=false, ripple and flash fuse
# their softmax arithmetic into FFMAs.
OWN_FLAGS = {"fused_reuse": ("--fmad=false",), "reuse_snap": ("--fmad=false",),
             "adaln": ("--fmad=false",), "sparse_attention": ("--fmad=false",),
             "ripple_attention": (), "flash_attention": ()}


@pytest.mark.parametrize("name", _build.SOURCES)
def test_each_sources_flags_are_the_documented_ones(name):
    assert set(OWN_FLAGS) == set(_build.SOURCES)
    assert _build.nvcc_flags(name) == _build.NVCC_FLAGS + OWN_FLAGS[name]


@pytest.mark.parametrize("name", ["ripple_attention", "sparse_attention"])
def test_tensor_core_kernels_include_the_shared_hopper_header(name):
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert '#include "hopper.cuh"' in text
    header = (_build.CSRC / "hopper.cuh").read_text()
    # The helpers are defined once, in the header, and not copied here.
    for definition in ("void mbar_wait(", "void tma_load(", "void wgmma_ss(",
                       "EncodeTiledFn encode_fn()"):
        assert definition in header and definition not in text


def test_a_change_to_the_hopper_header_moves_both_tensor_core_libraries(
        tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    for name in ("ripple_attention", "sparse_attention"):
        assert before[name] != after[name]
