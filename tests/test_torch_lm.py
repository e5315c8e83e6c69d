"""Parity of the port's LM family (``repro_torch.models.transformer_lm``,
``models.attention``'s LM attention, ``serving.engine.LMEngine`` and
``launch.workloads.lm_serve_steps``) with the JAX package's, on the CPU
at the smoke configs: the same numpy inputs and the JAX init's weights
through both.

Tolerances: masks, windows and configs bit-equal; float32 values within
``F32_REL`` of the JAX value's largest magnitude; bf16 logits within
relative L2 ``BF16_REL`` (two bf16 implementations: about 1e-2 measured
at the smoke depths).  The engine's and the workloads' cases are in
``tests/test_torch_lm_engine.py``, the MoE FFN's in
``tests/test_torch_moe.py``."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.configs.lm_shapes import LM_SHAPES as J_LM_SHAPES  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import transformer_lm as j_lm  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.lm_shapes import LM_SHAPES  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer_lm as lm  # noqa: E402
from repro_torch.models.common import apply_rope_1d  # noqa: E402
from repro_torch.models.params import (init_model, iter_specs,  # noqa: E402
                                       lm_param_specs, params_from_numpy)

torch.set_num_threads(2)

LMS = ["gemma3-4b", "qwen3-32b", "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]
F32_REL = 1e-5   # max abs error over the JAX value's max abs, float32
BF16_REL = 3e-2  # relative L2 of bf16 logits against the JAX package's


def _close(got, want, rel=F32_REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_init(name, seed=0):
    """(JAX smoke arch, JAX params, the port's smoke arch); JAX arrays
    are immutable, so one init serves every test."""
    j_arch = j_get_smoke(name)
    params = init_params(j_lm.lm_defs(j_arch.model), jax.random.PRNGKey(seed))
    return j_arch, params, get_smoke_config(name)


def _port(params, arch, dtype=torch.float32):
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params_from_numpy(tree, arch.model, device="cpu", dtype=dtype)


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# --- configs, shapes, windows, masks: bit-equal ------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", LMS)
def test_configs_equal_the_reference(name, smoke):
    port = (get_smoke_config if smoke else get_config)(name)
    ref = (j_get_smoke if smoke else j_get_config)(name)
    assert (port.name, port.family, port.source) == \
        (ref.name, ref.family, ref.source)
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert port.model.resolved_head_dim == ref.model.resolved_head_dim
    assert [dataclasses.asdict(s) for s in port.shapes] == \
        [dataclasses.asdict(s) for s in ref.shapes]
    assert dataclasses.asdict(port.ripple) == dataclasses.asdict(ref.ripple)
    assert dataclasses.asdict(port.train) == dataclasses.asdict(ref.train)
    assert dataclasses.asdict(port.checkpoint) == \
        dataclasses.asdict(ref.checkpoint)


def test_lm_shapes_equal_the_reference():
    assert [dataclasses.asdict(s) for s in LM_SHAPES] == \
        [dataclasses.asdict(s) for s in J_LM_SHAPES]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", LMS)
def test_layer_windows_bit_equal(name, smoke):
    port = (get_smoke_config if smoke else get_config)(name).model
    ref = (j_get_smoke if smoke else j_get_config)(name).model
    got, want = lm.layer_windows(port), j_lm.layer_windows(ref)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if name == "gemma3-4b" and not smoke:
        assert list(np.flatnonzero(got == 0)) == [5, 11, 17, 23, 29]


@pytest.mark.parametrize("S_q,S_kv,offset,window", [
    (7, 7, 0, 0), (7, 7, 0, 3), (1, 16, 9, 0), (1, 16, 9, 4),
    (5, 12, 4, 2), (4, 10, 0, 1)])
def test_causal_mask_bit_equal(S_q, S_kv, offset, window):
    got = attn.causal_mask(S_q, S_kv, offset, window).numpy()
    want = np.asarray(j_attn.causal_mask(S_q, S_kv, offset, window))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("kv_len", [5, 0, 12, [3, 12, 7]],
                         ids=["scalar", "empty", "full", "per-batch"])
def test_valid_mask_bit_equal(kv_len):
    got = attn.valid_mask(1, 12, torch.tensor(kv_len)).numpy()
    want = np.asarray(j_attn.valid_mask(1, 12, jnp.asarray(kv_len)))
    assert got.shape == want.shape and np.array_equal(got, want)
    # Decode's combined mask: the sum where both reject is -inf, as in JAX.
    both = (attn.valid_mask(3, 12, torch.tensor(kv_len))
            + attn.causal_mask(3, 12, 4, 2)).numpy()
    j_both = np.asarray(j_attn.valid_mask(3, 12, jnp.asarray(kv_len))
                        + j_attn.causal_mask(3, 12, 4, 2))
    assert np.array_equal(both, j_both)


# --- layers in float32 -----------------------------------------------------


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_1d(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = (np.arange(9)[None] + 5).astype(np.int32)
    got = apply_rope_1d(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = j_common.apply_rope_1d(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(_np(got), _np(want))


def _attn_pair(d, H, Hkv, hd, qk_norm, seed=2):
    """The same attention weights as a JAX dict and a port module."""
    rng = np.random.default_rng(seed)
    w = {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd),
         "wo": (H * hd, d)}
    jp = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for k, s in w.items()}
    port = attn.Attention(d, H, hd, qk_norm=qk_norm, n_kv=Hkv)
    with torch.no_grad():
        for k in w:
            getattr(port, k).copy_(torch.from_numpy(jp[k]))
        if qk_norm:
            for k in ("q_norm", "k_norm"):
                sc = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
                jp[k] = {"scale": sc}
                getattr(port, k).scale.copy_(torch.from_numpy(sc))
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    return jp, port


# (query heads, kv heads, qk-norm, window): G = 1, G = 2 and 4, qk-norm
# on and off, a sliding window.
ATTN_CASES = [(4, 4, False, 0), (4, 2, True, 0), (8, 2, True, 3),
              (4, 1, False, 5)]


@pytest.mark.parametrize("H,Hkv,qk_norm,window", ATTN_CASES)
def test_gqa_attention_prefill(H, Hkv, qk_norm, window):
    d, hd, S = 32, 8, 11
    jp, port = _attn_pair(d, H, Hkv, hd, qk_norm)
    x = np.random.default_rng(3).standard_normal((2, S, d)).astype(np.float32)
    pos = np.arange(S)[None].astype(np.int32)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=hd, rope_theta=1e4,
              sliding_window=window)
    out, (k, v) = attn.gqa_attention(port, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos), **kw)
    j_out, (jk, jv) = j_attn.gqa_attention(jp, jnp.asarray(x),
                                           positions=jnp.asarray(pos), **kw)
    _close(_np(out), _np(j_out))
    _close(_np(k), _np(jk))
    _close(_np(v), _np(jv))


@pytest.mark.parametrize("H,Hkv,qk_norm,window", ATTN_CASES)
def test_gqa_attention_decode(H, Hkv, qk_norm, window):
    """One new position written at cache_index 6 of a 16-position cache
    that holds 6 filled positions; the cache is written in place."""
    d, hd, S_max, idx = 32, 8, 16, 6
    jp, port = _attn_pair(d, H, Hkv, hd, qk_norm)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    kc = np.zeros((2, S_max, Hkv, hd), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :idx] = rng.standard_normal((2, idx, Hkv, hd))
    vc[:, :idx] = rng.standard_normal((2, idx, Hkv, hd))
    pos = np.array([[idx]], np.int32)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=hd, rope_theta=1e4,
              sliding_window=window)
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    out, new = attn.gqa_attention(port, torch.from_numpy(x),
                                  positions=torch.from_numpy(pos),
                                  cache=cache, cache_index=idx, **kw)
    j_out, j_new = j_attn.gqa_attention(
        jp, jnp.asarray(x), positions=jnp.asarray(pos),
        cache=(jnp.asarray(kc), jnp.asarray(vc)),
        cache_index=jnp.int32(idx), **kw)
    _close(_np(out), _np(j_out))
    assert new[0] is cache[0] and new[1] is cache[1]
    _close(_np(new[0]), _np(j_new[0]))
    _close(_np(new[1]), _np(j_new[1]))


def test_gqa_attention_refuses_a_write_past_the_cache():
    _, port = _attn_pair(32, 4, 2, 8, False)
    cache = (torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="exceeds the cache"):
        attn.gqa_attention(port, torch.zeros(1, 2, 32), n_heads=4, n_kv=2,
                           head_dim=8, positions=torch.tensor([[3, 4]]),
                           cache=cache, cache_index=3)


@pytest.mark.parametrize("mode", ["causal", "decode-shaped"])
def test_chunked_gqa_core(monkeypatch, mode):
    """The query-chunked core (taken above the logit budget when S is a
    multiple of the chunk) against the JAX package's, both packages'
    budget and chunk patched down from the test."""
    for mod in (attn, j_attn):
        monkeypatch.setattr(mod, "_CHUNK_LOGIT_BUDGET", 64)
        monkeypatch.setattr(mod, "_Q_CHUNK", 4)
    chunks = []
    dense = attn._gqa_core_dense
    monkeypatch.setattr(attn, "_gqa_core_dense",
                        lambda q, *a: chunks.append(q.shape[1]) or dense(q, *a))
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv, hd = 2, 16, 4, 2, 8
    S_kv = 16 if mode == "causal" else 24
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S_kv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S_kv, Hkv, hd)).astype(np.float32)
    if mode == "causal":
        mask = np.asarray(j_attn.causal_mask(S, S_kv, 0, 5))
    else:
        mask = np.asarray(j_attn.valid_mask(S, S_kv, 20)
                          + j_attn.causal_mask(S, S_kv, 4, 0))
    got = attn._gqa_core(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    want = j_attn._gqa_core(*(jnp.asarray(a) for a in (q, k, v, mask)),
                            j_attn.NULL_CTX)
    assert chunks == [4, 4, 4, 4]
    _close(_np(got), _np(want))
    # The mask as a function of the row range gives the same values.
    fn = attn._gqa_core(*(torch.from_numpy(a) for a in (q, k, v)),
                        lambda r0, r1: torch.from_numpy(mask[:, :, r0:r1]))
    assert torch.equal(fn, got)


# --- the whole model -------------------------------------------------------


@pytest.mark.parametrize("name", LMS)
def test_params_from_numpy_every_leaf(name):
    j_arch, params, arch = _jax_init(name)
    model = _port(params, arch)
    specs = lm_param_specs(arch.model)
    paths = [p for p, _ in iter_specs(specs)]
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert len(jax.tree_util.tree_leaves(params)) == len(paths)
    blk = params["blocks"]
    np.testing.assert_array_equal(model.blocks[1].attn.wk.numpy(),
                                  np.asarray(blk["attn"]["wk"])[1])
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))
    if "moe" in blk:
        np.testing.assert_array_equal(model.blocks[0].moe.wo.numpy(),
                                      np.asarray(blk["moe"]["wo"])[0])


@pytest.mark.parametrize("name", LMS)
def test_init_model_is_seeded_with_the_reference_scales(name):
    arch = get_smoke_config(name)
    a = init_model(arch.model, seed=3, device="cpu")
    b = init_model(arch.model, seed=3, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert torch.equal(a.final_norm.scale, torch.ones(arch.model.d_model))
    assert abs(a.embed.std().item() - 0.02) < 2e-3
    if arch.model.moe is not None:  # fan-in over d_model, not E * d_model
        want = arch.model.d_model ** -0.5
        assert abs(a.blocks[0].moe.wi_gate.std().item() - want) < 0.1 * want


@pytest.mark.parametrize("mode", ["all", "last", "none"])
@pytest.mark.parametrize("name", LMS)
def test_lm_apply_logits_modes(name, mode):
    j_arch, params, arch = _jax_init(name)
    model = _port(params, arch)
    toks = _tokens((2, 12), seed=1)
    got, cache, aux = lm.lm_apply(model, torch.from_numpy(toks), arch.model,
                                  compute_dtype=torch.float32,
                                  logits_mode=mode)
    want, _, j_aux = j_lm.lm_apply(params, jnp.asarray(toks), j_arch.model,
                                   compute_dtype=jnp.float32,
                                   logits_mode=mode)
    assert cache is None
    _close(_np(got), _np(want))
    if arch.model.moe is None:
        assert float(aux) == float(j_aux) == 0.0
    else:
        _close(aux.numpy(), np.asarray(j_aux))


@pytest.mark.parametrize("name", LMS)
def test_prefill_and_decode_match_lm_apply(name):
    """lm_prefill of 9 tokens, then 3 decode steps, against the JAX
    package's lm_apply over the whole sequence and its own
    lm_prefill / lm_decode_step."""
    j_arch, params, arch = _jax_init(name)
    model = _port(params, arch)
    toks = _tokens((2, 12), seed=2)
    f32 = dict(compute_dtype=torch.float32)
    logits, cache = lm.lm_prefill(model, torch.from_numpy(toks[:, :9]),
                                  arch.model, 16, **f32)
    assert cache[0].shape == (arch.model.num_layers, 2, 16,
                              arch.model.num_kv_heads,
                              arch.model.resolved_head_dim)
    steps = [logits]
    for i in range(9, 12):
        logits, cache = lm.lm_decode_step(
            model, torch.from_numpy(toks[:, i:i + 1]), cache, i, arch.model,
            **f32)
        steps.append(logits)
    full, _, _ = j_lm.lm_apply(params, jnp.asarray(toks), j_arch.model,
                               compute_dtype=jnp.float32)
    full = _np(full)
    for j, got in enumerate(steps[:3]):
        _close(_np(got)[:, 0], full[:, 8 + j])
    j_logits, j_cache = j_lm.lm_prefill(params, jnp.asarray(toks[:, :9]),
                                        j_arch.model, 16,
                                        compute_dtype=jnp.float32)
    _close(_np(steps[0]), _np(j_logits))
    j_logits, j_cache = j_lm.lm_decode_step(
        params, jnp.asarray(toks[:, 9:10]), j_cache, jnp.int32(9),
        j_arch.model, compute_dtype=jnp.float32)
    _close(_np(steps[1]), _np(j_logits))
    # The port's cache after all three steps holds the JAX one's first 10
    # positions (its positions 10 and 11 were written after).
    _close(_np(cache[0])[:, :, :10], _np(j_cache[0])[:, :, :10])


@pytest.mark.parametrize("name", LMS)
def test_bf16_decode_logits_within_the_bar(name):
    """bf16, as the card serves: the port's prefill and first decode
    step against the JAX package's lm_apply over the sequence, within
    relative L2 ``BF16_REL`` (the bar chip_smoke.py holds the card's
    decode logits to)."""
    j_arch, params, arch = _jax_init(name)
    model = _port(params, arch, dtype=torch.bfloat16)
    toks = _tokens((2, 19), seed=3)
    logits, cache = lm.lm_prefill(model, torch.from_numpy(toks[:, :18]),
                                  arch.model, 64)
    logits2, _ = lm.lm_decode_step(model, torch.from_numpy(toks[:, 18:]),
                                   cache, 18, arch.model)
    full = _np(j_lm.lm_apply(params, jnp.asarray(toks), j_arch.model)[0])
    assert logits.dtype == torch.bfloat16
    for got, want in ((logits, full[:, 17]), (logits2, full[:, 18])):
        assert _rel_l2(_np(got)[:, 0], want) < BF16_REL
