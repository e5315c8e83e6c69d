"""The fused Δ-check + snap wrapper on mixed text + grid operands read in
place, against the JAX package, and the arithmetic identities the CUDA
kernel (``csrc/fused_reuse.cu``) rests on.

On CPU tensors the wrapper runs its plain version, so these tests hold
the wrapper's ``grid_slice`` and strided-view semantics to
``repro.core.reuse.compute_reuse`` (on the grid tokens, text tokens passed
through) and to the port's host pipeline.  The kernel itself is held to
the same plain version on the card by ``chip_smoke.py``; what can be
checked here is the exact algebra it uses instead of the plain version's
steps: the square-root-free gate s < s*(θ) and the packed bf16 compare.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.reuse import compute_reuse as j_compute_reuse  # noqa: E402
from repro.kernels.reuse_mask.ops import (  # noqa: E402
    fused_compute_reuse as j_fused_compute_reuse)
from repro_torch.config.base import RippleConfig  # noqa: E402
from repro_torch.core.policy import snap_operand  # noqa: E402
from repro_torch.core.reuse import compute_reuse, snap_grid_tokens  # noqa: E402
from repro_torch.kernels.reuse_mask import ops as reuse_ops  # noqa: E402

torch.set_num_threads(2)

THETAS = {"t": 0.2, "x": 0.25, "y": 0.3}
N_TXT = 5


def _mixed(seed, B, H, grid, d, n_txt=N_TXT, noise=0.25):
    """(B, H, n_txt + T*H*W, d) float32: random text tokens, then smooth
    grid tokens whose neighbours along t, x and y differ by small steps."""
    T, Hh, W = grid
    rng = np.random.default_rng(seed)
    steps = noise * rng.standard_normal((B, H, T, Hh, W, d))
    g = rng.standard_normal((B, H, 1, 1, 1, d)) \
        + steps.cumsum(2).cumsum(3).cumsum(4)
    txt = rng.standard_normal((B, H, n_txt, d))
    return np.concatenate([txt, g.reshape(B, H, -1, d)], axis=2) \
        .astype(np.float32)


def _view(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x's values behind a non-contiguous layout of the same shape."""
    B, H, N, d = x.shape
    if kind == "transposed":  # (B, N, H, d) storage, as q before its copy
        return x.transpose(1, 2).contiguous().transpose(1, 2)
    if kind == "narrowed":    # padded tokens and channels around it
        big = torch.zeros((B, H, N + 7, d + 8), dtype=x.dtype)
        big[:, :, 3:3 + N, 4:4 + d] = x
        return big[:, :, 3:3 + N, 4:4 + d]
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_reference(x, grid, dtype, granularity, axes):
    """JAX compute_reuse on the grid tokens; text tokens passed through."""
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    seg = xj[:, :, N_TXT:]
    r = j_compute_reuse(seg, grid, {a: jnp.float32(v) for a, v in
                                    THETAS.items()},
                        axes=axes, granularity=granularity)
    snapped = np.concatenate([np.asarray(xj[:, :, :N_TXT].astype(jnp.float32)),
                              np.asarray(r.snapped.astype(jnp.float32))], axis=2)
    mask = np.concatenate([np.zeros(x[:, :, :N_TXT].shape, bool),
                           np.asarray(r.mask)], axis=2)
    return snapped, mask


@pytest.mark.parametrize("call", ["wrapper", "snap_operand"])
@pytest.mark.parametrize("view", ["contiguous", "transposed", "narrowed"])
@pytest.mark.parametrize("grid,axes,granularity", [
    ((4, 4, 4), ("t", "x", "y"), "channel"),
    ((2, 6, 4), ("y", "t", "x"), "token"),
    ((1, 4, 6), ("x", "y"), "channel"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_slice_on_views_bit_equal_to_jax(call, view, grid, axes,
                                              granularity, dtype):
    """The wrapper, or ``core.policy.snap_operand`` taking the fused path
    (one call on the whole operand), against JAX and the host pipeline."""
    N = grid[0] * grid[1] * grid[2]
    x = _mixed(N + len(axes), 2, 3, grid, 16)
    xt = _view(torch.from_numpy(x).to(getattr(torch, dtype)), view)
    if call == "wrapper":
        s_t, m_t = reuse_ops.fused_compute_reuse(
            xt, grid, THETAS, axes=axes, granularity=granularity,
            grid_slice=(N_TXT, N))
    else:
        cfg = RippleConfig(enabled=True, granularity=granularity)
        s_t, m_t = snap_operand(xt, True, grid, THETAS, cfg, axes,
                                (N_TXT, N), use_fused=True)
    s_j, m_j = _jax_reference(x, grid, dtype, granularity, axes)
    assert 0.05 < m_j.mean() < 0.95
    np.testing.assert_array_equal(m_t.numpy(), m_j)
    np.testing.assert_array_equal(_bits(s_t.float().numpy()), _bits(s_j))
    # and against the host pipeline on the contiguous operand
    s_h, m_h = snap_grid_tokens(xt.contiguous(), grid, THETAS, (N_TXT, N),
                                axes=axes, granularity=granularity)
    assert torch.equal(m_t, m_h)
    assert torch.equal(s_t.view(torch.int16 if dtype == "bfloat16" else
                                torch.int32),
                       s_h.view(torch.int16 if dtype == "bfloat16" else
                                torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_slice_bit_equal_to_jax_interpret(dtype):
    """The whole-operand call with text tokens against the JAX fused
    Pallas kernel (interpret mode) on the grid tokens."""
    grid = (2, 4, 4)
    N = 32
    x = _mixed(3, 1, 2, grid, 32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    s_j, m_j = j_fused_compute_reuse(
        xj[:, :, N_TXT:], grid, {a: jnp.float32(v) for a, v in THETAS.items()},
        interpret=True)
    s_t, m_t = reuse_ops.fused_compute_reuse(
        _view(torch.from_numpy(x).to(getattr(torch, dtype)), "transposed"),
        grid, THETAS, grid_slice=(N_TXT, N))
    np.testing.assert_array_equal(m_t[:, :, N_TXT:].numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(_bits(s_t[:, :, N_TXT:].float().numpy()),
                                  _bits(np.asarray(s_j.astype(jnp.float32))))


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_head_dims_bit_equal_to_jax_interpret(d, dtype):
    """unet-sd15's self-attention call shape at its head dims 40, 80 and
    160 (T = 1, axes x/y, every token a grid token; d 40 is 5 sixteen-byte
    chunks a bf16 row), on the (B, N, H, d) view ``mha_attention``
    transposes: the wrapper against the JAX fused Pallas kernel in
    interpret mode, bit for bit."""
    grid = (1, 8, 8)
    x = _mixed(d, 2, 2, grid, d, n_txt=0, noise=0.1)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    th = {"x": 0.2, "y": 0.2}
    s_j, m_j = j_fused_compute_reuse(
        xj, grid, {a: jnp.float32(v) for a, v in th.items()}, axes=("x", "y"),
        interpret=True)
    s_t, m_t = reuse_ops.fused_compute_reuse(
        _view(torch.from_numpy(x).to(getattr(torch, dtype)), "transposed"),
        grid, th, axes=("x", "y"))
    assert 0.05 < float(m_t.float().mean()) < 0.95
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(_bits(s_t.float().numpy()),
                                  _bits(np.asarray(s_j.astype(jnp.float32))))


@pytest.mark.parametrize("grid,axes,granularity", [
    ((4, 4, 4), ("t", "x", "y"), "channel"),
    ((2, 6, 4), ("y", "t", "x"), "token"),
    ((1, 4, 6), ("x", "y"), "channel"),
    ((3, 4, 5), ("x", "t", "y"), "channel"),  # remainders on t and x
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_source_map_bit_equal_to_jax(grid, axes, granularity, dtype):
    """``compute_reuse(want_src=True)`` against JAX's on the same values:
    the map is bit-equal, and gathering x by it gives ``snapped``."""
    N = grid[0] * grid[1] * grid[2]
    x = _mixed(20 + N, 2, 3, grid, 16, n_txt=0)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    th = {a: jnp.float32(v) for a, v in THETAS.items()}
    r_j = j_compute_reuse(xj, grid, th, axes=axes, granularity=granularity,
                          want_src=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    r_t = compute_reuse(xt, grid, THETAS, axes=axes,
                        granularity=granularity, want_src=True)
    assert r_t.src_idx.dtype == torch.int32
    np.testing.assert_array_equal(r_t.src_idx.numpy(), np.asarray(r_j.src_idx))
    assert 0.05 < float(r_t.mask.float().mean()) < 0.95
    gathered = torch.gather(xt, -2, r_t.src_idx)
    assert torch.equal(gathered, r_t.snapped)
    assert torch.equal(r_t.src_idx != torch.arange(N, dtype=torch.int32)[:, None],
                       r_t.mask)


@pytest.mark.parametrize("view", ["contiguous", "transposed", "narrowed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_source_map_equals_plain(view, dtype):
    """The wrapper's plain path with ``want_src`` on a text + grid operand
    read in place: the grid segment's map is the host pipeline's
    ``compute_reuse(want_src=True).src_idx`` and JAX's, and the snapped
    values and mask are the ones without the map."""
    grid = (2, 4, 4)
    x = _mixed(21, 2, 3, grid, 16)
    xt = _view(torch.from_numpy(x).to(getattr(torch, dtype)), view)
    s, m, src = reuse_ops.fused_compute_reuse(xt, grid, THETAS,
                                              grid_slice=(N_TXT, 32),
                                              want_src=True)
    s0, m0 = reuse_ops.fused_compute_reuse(xt, grid, THETAS,
                                           grid_slice=(N_TXT, 32))
    assert torch.equal(m, m0) and torch.equal(s, s0)
    assert src.shape == (2, 3, 32, 16)
    want = compute_reuse(xt[:, :, N_TXT:].contiguous(), grid, THETAS,
                         want_src=True).src_idx
    assert torch.equal(src, want)
    xj = jnp.asarray(x[:, :, N_TXT:]).astype(getattr(jnp, dtype))
    r_j = j_compute_reuse(xj, grid, {a: jnp.float32(v)
                                     for a, v in THETAS.items()},
                          want_src=True)
    np.testing.assert_array_equal(src.numpy(), np.asarray(r_j.src_idx))
    assert torch.equal(torch.gather(xt[:, :, N_TXT:], -2, src),
                       s[:, :, N_TXT:])


@pytest.mark.parametrize("view", ["contiguous", "transposed", "narrowed"])
def test_text_tokens_pass_through(view):
    grid = (2, 4, 4)
    x = _view(torch.from_numpy(_mixed(5, 2, 3, grid, 16, n_txt=7)), view)
    # grid tokens in the middle: 3 text tokens before, 4 after
    s, m = reuse_ops.fused_compute_reuse(x, grid, {a: 10.0 for a in "txy"},
                                         grid_slice=(3, 32))
    text = torch.cat([torch.arange(3), torch.arange(35, 39)])
    assert m.dtype == torch.bool
    assert not bool(m[:, :, text].any())
    assert torch.equal(s[:, :, text], x[:, :, text])
    assert bool(m[:, :, 3:35].any())  # θ 10 snaps every follower


@pytest.mark.parametrize("grid_slice", [(0, 31), (9, 32), (-1, 32)])
def test_grid_slice_must_hold_the_grid(grid_slice):
    x = torch.zeros((1, 1, 40, 8))
    with pytest.raises(ValueError, match="grid slice"):
        reuse_ops.fused_reuse_snap(x, (0.2, 0.2, 0.2), grid=(2, 4, 4),
                                   grid_slice=grid_slice)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((3, 4, 10, 8)),
    lambda: torch.zeros((3, 10, 4, 8)).transpose(1, 2),
    lambda: torch.zeros((2, 3, 4, 10, 8)),
    lambda: torch.zeros((2, 3, 4, 10, 8))[:, 1:],
    lambda: torch.zeros((1, 5, 1, 10, 8)),
    lambda: torch.zeros((10, 8)),
    lambda: torch.zeros((6, 4, 12, 16))[::2, :, 1:11, 4:12],
])
def test_lead_dims_address_the_view(make):
    """The kernel's addressing: element (l0, l1, n, c) of the view lies at
    storage offset l0*s0 + l1*s1 + n*sN + c (plus the view's own offset);
    views whose lead dims fold into two need no copy."""
    x = make()
    x.copy_(torch.arange(x.numel(), dtype=x.dtype).reshape(x.shape))
    lead = reuse_ops._lead_dims(x)
    assert lead is not None
    n0, n1, s0, s1 = lead
    N, d = x.shape[-2:]
    base = torch.as_strided(x, (n0, n1, N, d), (s0, s1, x.stride(-2), 1))
    assert torch.equal(base.reshape(x.shape), x)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((2, 3, 4, 10, 8)).transpose(1, 2),
    lambda: torch.zeros((2, 3, 4, 10, 8)).permute(2, 0, 1, 3, 4)[:, :, ::2],
])
def test_lead_dims_that_do_not_fold_ask_for_a_copy(make):
    assert reuse_ops._lead_dims(make()) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_theta_rounding_matches_torch(dtype):
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(0, 1, 200), rng.uniform(0, 1e-30, 20),
                           [0.0, -0.0, 0.2, 0.25, 0.3, 0.5, 1 / 3, 3.4e38,
                            float("inf"), 1e-45, 2.0 ** -126]])
    for v in vals:
        want = float(torch.tensor(float(v), dtype=torch.float32).to(dtype))
        assert np.float32(reuse_ops.round_to(float(v), dtype)).tobytes() == \
            np.float32(want).tobytes(), v


# ---------------------------------------------------------------------------
# The kernel's algebra, exhaustively over bf16
# ---------------------------------------------------------------------------


def _bf16_raw_to_f32(raw):
    return (np.asarray(raw, np.uint32) << 16).view(np.float32)


def _f32_to_bf16_rn(f):
    b = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    out = b.astype(np.uint32)
    nan = np.isnan(np.asarray(f, np.float32))
    return np.where(nan, np.uint32(0x7FC0), out)


def _ru_f32(x: float) -> np.float32:
    with np.errstate(over="ignore"):
        f = np.float32(x)
    return np.nextafter(f, np.float32(np.inf)) if float(f) < x else f


def _sstar_bf16(th_raw: int) -> int:
    """The kernel's Bf16Word::sstar, step by step."""
    if th_raw == 0 or th_raw > 0x7F80:
        return 0
    th = float(_bf16_raw_to_f32(th_raw))
    b = 0.5 * (float(_bf16_raw_to_f32(th_raw - 1)) + th)
    f = _ru_f32(b * b)
    bits = int(np.float32(f).view(np.uint32))
    return (bits >> 16) + (1 if bits & 0xFFFF else 0)  # round up to bf16


_TH_RAW = sorted({0, 1, 2, 0x7F, 0x80, 0x81, 0x3E4C, 0x3E80, 0x3E99, 0x3F00,
                  0x3F80, 0x4120, 0x7F7F, 0x7F80, 0x7FC0, 0x8000, 0xBE4C}
                 | set(range(0x3C00, 0x3C80)))


def test_sstar_gate_equals_rooted_gate_bf16():
    """Δ = bf16(sqrt_f32(s)) < θ  <=>  s < s*(θ), for every bf16 s ≥ +0
    (and the NaNs) and each θ tried, as the plain version computes Δ."""
    s_raw = np.arange(0, 0x8000, dtype=np.uint32)
    s_raw = np.concatenate([s_raw, [0xFFC0, 0xFF81]])
    s = _bf16_raw_to_f32(s_raw)
    with np.errstate(invalid="ignore"):
        delta = _bf16_raw_to_f32(_f32_to_bf16_rn(np.sqrt(s)))
    for th_raw in _TH_RAW:
        th = _bf16_raw_to_f32(th_raw)
        with np.errstate(invalid="ignore"):
            want = delta < th
        ss = _sstar_bf16(th_raw)
        with np.errstate(invalid="ignore"):
            got = s < _bf16_raw_to_f32(ss)
        assert np.array_equal(got, want), hex(th_raw)


def test_sstar_gate_equals_rooted_gate_f32():
    rng = np.random.default_rng(1)
    s = np.concatenate([rng.uniform(0, 1, 100000).astype(np.float32) ** 4,
                        np.float32([0, np.inf, np.nan, 1e-45, 1e-40])])
    for th in np.float32([0.2, 0.25, 0.3, 1e-3, 1e-40, 7.0, np.inf, 0.0,
                          -0.5]):
        u = int(np.float32(th).view(np.uint32))
        if u == 0 or u > 0x7F800000:
            ss = np.float32(0)
        else:
            prev = np.uint32(u - 1).view(np.float32)
            b = 0.5 * (float(prev) + float(th))
            ss = _ru_f32(b * b)
        with np.errstate(invalid="ignore", over="ignore"):
            want = np.sqrt(s) < th
            got = s < ss
        assert np.array_equal(got, want), th
        # and on the values around s* itself
        near = np.nextafter(np.float32(ss), np.float32([0, np.inf]))
        with np.errstate(invalid="ignore"):
            assert np.array_equal(near < ss, np.sqrt(near) < th)


def test_packed_bf16_compare_equals_float_compare():
    """Bf16Word::below on packed words: all ones in a lane iff s < s*, for
    every s a lane can hold (+0 .. +inf and the NaNs of either sign)."""
    s_raw = np.concatenate([np.arange(0, 0x7F81), np.arange(0x7F81, 0x8000, 7),
                            np.arange(0xFF81, 0x10000, 5)]).astype(np.uint32)
    s = _bf16_raw_to_f32(s_raw)
    rng = np.random.default_rng(2)
    partner = rng.choice(s_raw, s_raw.size)
    for ss in (0, 1, 0x3E4C, 0x3F80, 0x7F7F, 0x7F80):
        for lo, hi in ((s_raw, partner), (partner, s_raw)):
            w = lo | (hi << 16)
            t = ((w | 0x80008000) - (ss | (ss << 16))) & 0xFFFFFFFF
            got = (((~t & 0x80008000) >> 15) * 0xFFFF) & 0xFFFFFFFF
            with np.errstate(invalid="ignore"):
                want_lo = _bf16_raw_to_f32(lo) < _bf16_raw_to_f32(ss)
                want_hi = _bf16_raw_to_f32(hi) < _bf16_raw_to_f32(ss)
            assert np.array_equal((got & 0xFFFF) == 0xFFFF, want_lo)
            assert np.array_equal((got >> 16) == 0xFFFF, want_hi)
            assert np.all(((got & 0xFFFF) == 0) | ((got & 0xFFFF) == 0xFFFF))
    del s


def test_axis_orders_cover_every_priority():
    """Every axes tuple maps to the permutation the kernel indexes, with
    the absent axes after the present ones."""
    import itertools

    for n in range(1, 4):
        for axes in itertools.permutations("txy", n):
            order = [reuse_ops._AXIS_ID[a] for a in axes]
            order += [i for i in range(3) if i not in order]
            assert tuple(order) in reuse_ops._ORDERS

