"""The port's kernel micro-bench against the JAX package's: the
deterministic part of ``correlated_video_latents`` on JAX's own base
noise, the matched-savings θ search, the savings rows on the same
operands, and the entry point's rows on the CPU."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.synthetic import (  # noqa: E402
    correlated_video_latents as j_latents)
from repro_torch.data.synthetic import (  # noqa: E402
    correlated_video_latents, smooth_ar_latents)
from repro_torch.launch import kernel_bench  # noqa: E402

torch.set_num_threads(2)

SMALL = (4, 8, 8)


@pytest.fixture
def ref_bench(monkeypatch, request):
    """The JAX package's ``benchmarks/kernel_bench.py`` (it imports
    ``benchmarks.common``, so the repository root goes on the path for
    this test only), cut to the small grid."""
    monkeypatch.syspath_prepend(str(request.config.rootpath))
    kb = importlib.import_module("benchmarks.kernel_bench")
    monkeypatch.setattr(kb, "GRID", SMALL)
    monkeypatch.setattr(kb, "N", int(np.prod(SMALL)))
    monkeypatch.setattr(kb, "D", 32)
    return kb


@pytest.mark.parametrize("rho,smooth", [(0.97, 3), (0.9, 0)])
def test_latents_match_jax_on_its_noise(rho, smooth):
    key = jax.random.PRNGKey(3)
    shape = (2, *SMALL, 16)
    base = jax.random.normal(jax.random.split(key)[0], shape)
    want = np.asarray(j_latents(key, 2, SMALL, 16, temporal_rho=rho,
                                spatial_smooth=smooth))
    got = smooth_ar_latents(torch.from_numpy(np.array(base)),
                            temporal_rho=rho, spatial_smooth=smooth).numpy()
    # f32: the same ops in the same order; reductions (the std) may sum
    # in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_latents_from_a_generator():
    g = torch.Generator().manual_seed(1)
    x = correlated_video_latents(g, 2, SMALL, 8, temporal_rho=0.95)
    assert x.shape == (2, *SMALL, 8) and x.dtype == torch.float32
    assert x.std(correction=0).item() == pytest.approx(1.0, abs=1e-5)
    # neighbouring frames are correlated
    c = torch.corrcoef(torch.stack([x[:, 1:].flatten(), x[:, :-1].flatten()]))
    assert c[0, 1].item() > 0.8
    g2 = torch.Generator().manual_seed(1)
    assert torch.equal(x, correlated_video_latents(g2, 2, SMALL, 8,
                                                   temporal_rho=0.95))


@pytest.mark.parametrize("granularity,target", [("channel", 0.5),
                                                ("token", 0.75)])
def test_theta_for_savings_matches_jax(ref_bench, granularity, target):
    common = importlib.import_module("benchmarks.common")
    q, k = ref_bench._qk()
    want = common.theta_for_savings(q, k, target, grid=SMALL,
                                    granularity=granularity)
    got = kernel_bench.theta_for_savings(
        torch.from_numpy(np.array(q)), torch.from_numpy(np.array(k)),
        target, grid=SMALL, granularity=granularity)
    assert got == want


def test_run_rows_equal_jax_on_the_same_operands(ref_bench):
    q, k = ref_bench._qk()
    want = ref_bench.run()
    got = kernel_bench.run(torch.from_numpy(np.array(q)),
                           torch.from_numpy(np.array(k)), grid=SMALL)
    assert got == want
    assert any(r["mxu_block_skip_tmajor"] > 0 for r in got)


# The reference's row names and fields (benchmarks/kernel_bench.py::main).
RUN_FIELDS = ["paper", "collapse_q", "collapse_k", "mxu_skip_x", "mxu_skip_t",
              "protected:paper"]
MASK_FIELDS = ["fused_bytes", "host_bytes", "bytes_ratio", "fused_us",
               "host_us", "walltime_ratio", "fused_le_host"]
SPARSE_FIELDS = ["skip_rate", "mask_savings", "modeled_attn_speedup",
                 "sparse_us", "dense_map_us", "dense_flash_us",
                 "walltime_speedup"]
AMORT_FIELDS = ["decide_us", "apply_us", "R1", "R2", "R4", "R8", "red_R1",
                "red_R2", "red_R4", "red_R8"]
STATIC_FIELDS = ["apply_ratio", "static_apply_us", "ripple_apply_us",
                 "skip_rate", "static_frac", "map_stable", "matched_savings",
                 "psnr_static", "psnr_ripple", "psnr_delta_db"]


def _fields(line):
    name, _, rest = line.split(",", 2)
    return name, [kv.split("=")[0] for kv in rest.split(";")]


def test_main_prints_the_reference_rows_on_cpu(capsys):
    out = kernel_bench.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("kernel_bench[")]
    rows = dict(_fields(ln) for ln in lines)
    assert rows == {"kernel_bench[75%]": RUN_FIELDS,
                    "kernel_bench[85%]": RUN_FIELDS,
                    "kernel_bench[mask_fusion@vdit_paper32x32x32xd128]":
                        MASK_FIELDS,
                    "kernel_bench[sparse@vdit_paper8x16x16xd64]":
                        SPARSE_FIELDS,
                    "kernel_bench[decision_amortization@vdit_paper8x16x16"
                    "xd64/ripple]": AMORT_FIELDS,
                    "kernel_bench[decision_amortization@vdit_paper8x16x16"
                    "xd64/svg]": AMORT_FIELDS,
                    "kernel_bench[static_pattern@vdit_paper8x16x16xd64]":
                        STATIC_FIELDS}
    mask, sparse, static = out[2], out[3], out[6]
    assert mask["fused_le_host"] and 0 < mask["bytes_ratio"] < 1
    assert 0 < sparse["skip_rate"] < 1 and sparse["dense_flash_us"] > 0
    assert [r["policy"] for r in out[4:6]] == ["ripple", "svg"]
    assert static["map_stable"] and 0 < static["skip_rate"] < 1


def test_decision_amortization_rows_on_cpu():
    """The section at a small grid: both policies, the reference's row
    fields, and the cadence arithmetic (R=1 is one decision a step)."""
    rows = kernel_bench.decision_amortization(grid=SMALL, d=16,
                                              device="cpu")
    assert [r["policy"] for r in rows] == ["ripple", "svg"]
    for r in rows:
        assert r["grid"] == SMALL and r["decide_us"] > 0
        assert set(r["per_step_us"]) == {1, 2, 4, 8}
        assert r["per_step_us"][1] == r["decide_us"]
        assert r["reduction"][1] == 1.0
        assert _fields(kernel_bench.amortization_row(r))[1] == AMORT_FIELDS


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.main([])
