"""The port's LM serving path against the JAX package's on the CPU at
the smoke configs: ``serving.engine.LMEngine`` (greedy token ids equal
to the JAX engine's on the JAX init, and its validation) and
``launch.workloads.lm_serve_steps`` against the reference's
``build_workload(...).fn`` (bf16 logits within relative L2
``BF16_REL``).  Helpers and bars are ``tests/test_torch_lm.py``'s."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.workloads import build_workload  # noqa: E402
from repro.models import transformer_lm as j_lm  # noqa: E402
from repro.serving.engine import LMEngine as JLMEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.workloads import lm_serve_steps  # noqa: E402
from repro_torch.models import transformer_lm as lm  # noqa: E402
from repro_torch.models.params import init_model  # noqa: E402
from repro_torch.serving.engine import LMEngine  # noqa: E402
from test_torch_lm import (BF16_REL, LMS, _jax_init, _np, _port,  # noqa: E402
                           _rel_l2, _tokens)

torch.set_num_threads(2)


@pytest.mark.parametrize("name", LMS)
def test_engine_greedy_tokens_equal_the_jax_engines(name):
    """As tests/test_diffusion.py's LM engine check: greedy generation
    from the JAX init, f32, the same token ids in both packages, and
    equal to greedy over repeated full forwards."""
    j_arch, params, arch = _jax_init(name)
    model = _port(params, arch)
    cfg, j_cfg = arch.model, j_arch.model
    eng = LMEngine(
        lambda t: lm.lm_prefill(model, t, cfg, 32,
                                compute_dtype=torch.float32),
        lambda t, c, i: lm.lm_decode_step(model, t, c, i, cfg,
                                          compute_dtype=torch.float32),
        max_len=32)
    j_eng = JLMEngine(
        lambda t: j_lm.lm_prefill(params, t, j_cfg, 32,
                                  compute_dtype=jnp.float32),
        lambda t, c, i: j_lm.lm_decode_step(params, t, c, i, j_cfg,
                                            compute_dtype=jnp.float32),
        max_len=32)
    prompt = _tokens((2, 5), seed=4)
    got = eng.generate(torch.from_numpy(prompt), num_new=6)
    want = np.asarray(j_eng.generate(jnp.asarray(prompt), num_new=6))
    np.testing.assert_array_equal(got.numpy(), want)
    seq = torch.from_numpy(prompt)
    for _ in range(6):
        logits, _, _ = lm.lm_apply(model, seq, cfg,
                                   compute_dtype=torch.float32)
        seq = torch.cat([seq, torch.argmax(logits[:, -1], -1)[:, None]], 1)
    np.testing.assert_array_equal(seq[:, 5:].numpy(), want)


class TestLMEngineValidation:
    """tests/test_serving.py's TestLMEngineValidation on the port."""

    def _engine(self, max_len=8):
        V = 5

        def prefill(tokens):
            B, S = tokens.shape
            return torch.zeros((B, S, V)), {}

        def decode(tok, cache, idx):
            return torch.zeros((tok.shape[0], 1, V)), cache

        return LMEngine(prefill, decode, max_len=max_len)

    def test_temperature_without_rng_raises(self):
        with pytest.raises(ValueError, match="rng"):
            self._engine().generate(torch.zeros((1, 2), dtype=torch.long),
                                    num_new=2, temperature=0.7)

    def test_temperature_with_rng_works(self):
        g = torch.Generator().manual_seed(0)
        out = self._engine().generate(torch.zeros((1, 2), dtype=torch.long),
                                      num_new=2, temperature=0.7, rng=g)
        assert out.shape == (1, 2) and bool(((out >= 0) & (out < 5)).all())

    def test_max_len_enforced(self):
        eng = self._engine(max_len=8)
        toks = torch.zeros((1, 6), dtype=torch.long)
        with pytest.raises(ValueError, match="max_len"):
            eng.generate(toks, num_new=3)
        assert eng.generate(toks, num_new=2).shape == (1, 2)

    def test_sampling_is_seeded(self):
        """Temperature draws come from the generator alone."""
        j_arch, params, arch = _jax_init("qwen3-32b")
        model = _port(params, arch)
        pre, dec = lm_serve_steps(arch, arch.shape("decode_32k"), model)
        eng = LMEngine(pre, dec, max_len=64)
        prompt = torch.from_numpy(_tokens((2, 4), seed=5))
        runs = [eng.generate(prompt, 5, temperature=1.0,
                             rng=torch.Generator().manual_seed(s))
                for s in (7, 7, 8)]
        assert torch.equal(runs[0], runs[1])
        assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", ["gemma3-4b", "qwen2-moe-a2.7b"])
def test_serve_steps_match_the_reference_workloads(name, shape_name):
    """The port's prefill and decode callables against the reference's
    ``build_workload(arch, shape, None).fn`` (bf16, cache of the shape's
    32768 positions) on a 2 x 8 prompt and one decode step."""
    j_arch, params, arch = _jax_init(name)
    model = _port(params, arch, dtype=torch.bfloat16)
    prefill, decode = lm_serve_steps(arch, arch.shape(shape_name), model)
    toks = _tokens((2, 9), seed=6)
    logits, cache = prefill(torch.from_numpy(toks[:, :8]))
    j_pre = build_workload(j_arch, "prefill_32k", None).fn
    j_logits, j_cache = j_pre(params, jnp.asarray(toks[:, :8]))
    assert cache[0].shape == tuple(j_cache[0].shape)
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 1, 256)
    assert _rel_l2(_np(logits), _np(j_logits)) < BF16_REL
    logits, cache = decode(torch.from_numpy(toks[:, 8:]), cache, 8)
    j_dec = build_workload(j_arch, "decode_32k", None).fn
    j_logits, _ = j_dec(params, jnp.asarray(toks[:, 8:]), j_cache,
                        jnp.int32(8))
    assert _rel_l2(_np(logits), _np(j_logits)) < BF16_REL


def test_serve_steps_refuse_other_families_and_shapes():
    arch = get_smoke_config("qwen3-32b")
    model = init_model(arch.model, device="cpu")
    with pytest.raises(ValueError, match="no LM serving workload"):
        lm_serve_steps(arch, arch.shape("train_4k"), model)
    vit = get_smoke_config("vit-l16")
    with pytest.raises(ValueError, match="no LM serving workload"):
        lm_serve_steps(vit, vit.shape("serve_b1"), model)


def test_lm_apply_refuses_a_foreign_config():
    arch = get_smoke_config("qwen3-32b")
    model = init_model(arch.model, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        lm.lm_apply(model, torch.zeros((1, 2), dtype=torch.long),
                    get_smoke_config("gemma3-4b").model)
    with pytest.raises(ValueError, match="logits_mode"):
        lm.lm_apply(model, torch.zeros((1, 2), dtype=torch.long),
                    logits_mode="first")
