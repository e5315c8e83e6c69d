"""The port's roofline module (``repro_torch.launch.roofline``) against
the JAX package's, and the kernels' counting hook: the model-FLOP
estimates, token counts and parameter counts equal the reference's on
every config and shape; each kernel wrapper handed fake tensors inside
``kernels.counting_kernels`` records its formula's operations and bytes
(written out here) and returns empty outputs of the right shape; a real
tensor inside the context still takes its plain path."""

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ALL_ARCHS as J_ALL_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch.workloads import model_fns  # noqa: E402
from repro.models.params import param_count as j_param_count  # noqa: E402
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import counting_kernels, on_card  # noqa: E402
from repro_torch.kernels.adaln.ops import adaln_modulate  # noqa: E402
from repro_torch.kernels.adaln.ref import adaln_modulate_ref  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402
from repro_torch.kernels.reuse_mask.ops import (fused_reuse_snap,  # noqa: E402
                                                reuse_snap)
from repro_torch.kernels.reuse_mask.ref import (fused_reuse_ref,  # noqa: E402
                                                reuse_snap_plain)
from repro_torch.kernels.ripple.ops import (attention_scale,  # noqa: E402
                                            ripple_attention)
from repro_torch.kernels.ripple.ref import ripple_attention_ref  # noqa: E402
from repro_torch.kernels.sparse.ops import sparse_attention  # noqa: E402
from repro_torch.kernels.sparse.ref import sparse_attention_ref  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

torch.set_num_threads(2)


def test_assigned_archs_are_the_references():
    from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED

    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert sorted(ALL_ARCHS) == sorted(J_ALL_ARCHS)


@pytest.mark.parametrize("name", sorted(J_ALL_ARCHS))
def test_model_flops_tokens_and_params_equal_the_reference(name):
    ja, pa = j_get_config(name), get_config(name)
    n_j = j_param_count(model_fns(ja))
    n_p = rl.param_count(pa.model)
    assert n_p == n_j
    if ja.family == "lm":
        act_j, act_p = jrl.active_params_lm(ja.model), rl.active_params_lm(pa.model)
        assert act_p == act_j
        if ja.model.moe is not None:
            assert act_p < n_p
    else:
        act_j = act_p = n_j
    assert [s.name for s in pa.shapes] == [s.name for s in ja.shapes]
    for sj, sp in zip(ja.shapes, pa.shapes):
        assert rl.model_flops_estimate(pa, sp, n_p, act_p) == \
            jrl.model_flops_estimate(ja, sj, n_j, act_j), sp.name
        if ja.family != "lm":
            assert rl._vision_tokens(pa, sp) == jrl._vision_tokens(ja, sj)


def test_analyze_values_terms():
    arch = get_config("dit-xl2")
    shape = arch.shape("train_256")
    r = rl.analyze_values(989e12, 3.35e12, {"all-gather": 225e9}, arch, shape,
                          "2x1", 2, 1000, kernel_s=0.5)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.5, 1.0, 0.5)
    assert r.dominant == "compute" and r.bound_s == 1.5
    assert r.model_flops == 6.0 * 1000 * 256 * 256
    assert r.useful_ratio == r.model_flops / (2 * 989e12)
    assert set(r.row()) >= {"arch", "shape", "mesh", "compute_s", "memory_s",
                            "collective_s", "dominant", "model_flops",
                            "hlo_flops", "useful_ratio", "peak_mem_gb"}


def _fake(mode, shape, dtype=torch.bfloat16):
    with mode:
        return torch.empty(shape, dtype=dtype)


# Each kernel at a small shape: the call, its outputs' shapes and dtypes,
# and its operations, their type, its bytes and exponentials, written out.
def _cases(m):
    b16, f32 = torch.bfloat16, torch.float32
    x = _fake(m, (1, 2, 32, 8))                        # grid (2, 4, 4)
    q, k, v = (_fake(m, (1, 2, 64, 16)) for _ in range(3))
    sq, sk, sv = (_fake(m, (1, 2, 256, 32), f32) for _ in range(3))
    fq, fk, fv = (_fake(m, s) for s in ((1, 2, 64, 16), (1, 2, 32, 16),
                                        (1, 2, 32, 8)))
    xs = _fake(m, (1, 2, 8, 16))
    xa, sh, sc = (_fake(m, s) for s in ((2, 8, 16), (2, 16), (2, 16)))
    return {
        # 512 grid elements x 19.5 ops; read 2 B, write 2 B + 1 mask byte.
        "fused_reuse": (lambda: fused_reuse_snap(x, (0.2,) * 3, grid=(2, 4, 4)),
                        [((1, 2, 32, 8), b16), ((1, 2, 32, 8), torch.bool)],
                        (9984.0, "float32", 2560, 0.0)),
        # With the source map: 4 bytes more a grid element.
        "fused_reuse src": (lambda: fused_reuse_snap(
            x, (0.2,) * 3, grid=(2, 4, 4), want_src=True),
            [((1, 2, 32, 8), b16), ((1, 2, 32, 8), torch.bool),
             ((1, 2, 32, 8), torch.int32)], (9984.0, "float32", 4608, 0.0)),
        # 2 N^2 (d + dv) a head, nothing collapsed; one exponential a score.
        "ripple_attention": (lambda: ripple_attention(q, k, v),
                             [((1, 2, 64, 16), b16)],
                             (524288.0, "bfloat16", 16384, 8192.0)),
        # Every tile live; q, k, v, out in f32 and the 2 x 2 int32 maps.
        "sparse_attention": (lambda: sparse_attention(sq, sk, sv),
                             [((1, 2, 256, 32), f32)],
                             (16777216.0, "float32", 262176, 0.0)),
        "flash_attention": (lambda: flash_attention(fq, fk, fv),
                            [((1, 2, 64, 8), b16)],
                            (196608.0, "bfloat16", 9216, 0.0)),
        # 4 ops a pair-channel; read 2 B, write 2 B + 1 mask byte.
        "reuse_snap": (lambda: reuse_snap(xs, 0.3),
                       [((1, 2, 8, 16), b16), ((1, 2, 8, 16), torch.int8)],
                       (512.0, "float32", 1280, 0.0)),
        # 10 ops an element; x read and written, shift and scale read.
        "adaln": (lambda: adaln_modulate(xa, sh, sc), [((2, 8, 16), b16)],
                  (2560.0, "float32", 1152, 0.0)),
    }


@pytest.mark.parametrize("case", ["fused_reuse", "fused_reuse src",
                                  "ripple_attention", "sparse_attention",
                                  "flash_attention", "reuse_snap", "adaln"])
def test_counted_kernel_call_is_the_formula(case):
    mode = FakeTensorMode()
    call, outs, (ops, dtype, nbytes, exps) = _cases(mode)[case]
    with mode, counting_kernels() as calls:
        out = call()
    out = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in out] == outs
    assert [n for n, _ in calls] == [case.split()[0]]
    w = calls[0][1]
    assert (w.ops, w.ops_dtype, w.nbytes, w.exps) == (ops, dtype, nbytes, exps)


def test_fake_tensors_reach_no_kernel_outside_the_context():
    mode = FakeTensorMode()
    q = _fake(mode, (1, 2, 64, 16))
    assert not on_card(q)
    with counting_kernels():
        assert on_card(q)
    # A fake CPU tensor outside the context is a CPU tensor: the plain path.
    with mode:
        out = ripple_attention(q, q, q)
    assert out.shape == (1, 2, 64, 16)


def test_real_tensors_take_their_plain_path_inside_the_context():
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=torch.float32):
        return torch.randn(s, generator=g).to(dtype)

    x = r(1, 2, 32, 8)
    q, k, v = r(1, 2, 64, 16), r(1, 2, 64, 16), r(1, 2, 64, 16)
    xa, sh, sc = r(2, 8, 16), r(2, 16), r(2, 16)
    th = dict(zip("txy", (0.2,) * 3))
    with counting_kernels() as calls:
        assert not on_card(x)
        got = [fused_reuse_snap(x, (0.2,) * 3, grid=(2, 4, 4))[0],
               ripple_attention(q, k, v), sparse_attention(q, k, v),
               flash_attention(q, k, v), reuse_snap(q, 0.3)[0],
               adaln_modulate(xa, sh, sc)]
    assert calls == []
    want = [fused_reuse_ref(x, (2, 4, 4), th)[0],
            ripple_attention_ref(q, k, v, attention_scale(16)),
            sparse_attention_ref(q, k, v, scale=float(1.0 / 16 ** 0.5)),
            attention_ref(q, k, v), reuse_snap_plain(q, 0.3)[0],
            adaln_modulate_ref(xa, sh, sc)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
