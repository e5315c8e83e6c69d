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

