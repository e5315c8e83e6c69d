"""Parity of the port's MoE FFN (``repro_torch.models.moe``) with the JAX
package's ``repro.models.moe`` on the CPU: the router (top-k indices
equal; weights and aux loss in float32 within ``F32_REL``), the
expert-batched FFN, and ``moe_ffn`` on the dense path with and without
shared experts (float32 within ``F32_REL``, bf16 within relative L2
``BF16_REL``); ``impl="ep"`` without a mesh or under autograd raises
(expert parallelism itself: ``tests/test_torch_moe_ep.py``).  Bars are
``tests/test_torch_lm.py``'s."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro_torch.config.base import MoEConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_lm import BF16_REL, _close, _np, _rel_l2  # noqa: E402

torch.set_num_threads(2)

D = 32
# The two smoke configs' MoEs (shared experts or not) and a router as
# wide as qwen2-moe's: 64 experts, top-4.
CASES = {
    "qwen2-moe-smoke": get_smoke_config("qwen2-moe-a2.7b").model.moe,
    "phi3.5-moe-smoke": get_smoke_config("phi3.5-moe-42b-a6.6b").model.moe,
    "64 experts top-4 + 1 shared": MoEConfig(
        num_experts=64, num_shared_experts=1, top_k=4, expert_ffw_dim=16),
}


def _pair(cfg: MoEConfig, seed=0, dtype=torch.float32):
    """JAX ``moe_defs`` params from the JAX init, and the port's MoE with
    the same leaves."""
    j_cfg = JMoEConfig(**dataclasses.asdict(cfg))
    params = init_params(j_moe.moe_defs(D, j_cfg), jax.random.PRNGKey(seed))
    port = moe.MoE(D, cfg, dtype=dtype)
    with torch.no_grad():
        for k in ("router", "wi_gate", "wi_up", "wo"):
            getattr(port, k).copy_(torch.from_numpy(np.asarray(params[k])))
        if cfg.num_shared_experts:
            for k in ("wi_gate", "wi_up", "wo", "gate"):
                getattr(port.shared, k).copy_(
                    torch.from_numpy(np.asarray(params["shared"][k])))
    return j_cfg, params, port


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_router_matches(name):
    cfg = CASES[name]
    j_cfg, params, port = _pair(cfg)
    x = _x((40, D))
    idx, w, aux = moe._router(port, torch.from_numpy(x), cfg)
    j_idx, j_w, j_aux = j_moe._router(params, jnp.asarray(x), j_cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert w.dtype == torch.float32 and aux.dtype == torch.float32
    _close(w.numpy(), np.asarray(j_w))
    _close(aux.numpy(), np.asarray(j_aux))
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_router_breaks_ties_by_index(name):
    """Equal router probabilities (common with bf16 logits) select the
    lower expert index first, as ``lax.top_k`` does."""
    cfg = CASES[name]
    j_cfg, params, port = _pair(cfg)
    x = np.zeros((3, D), np.float32)
    x[1, :4] = 1.0
    idx, _, _ = moe._router(port, torch.from_numpy(x), cfg)
    j_idx, _, _ = j_moe._router(params, jnp.asarray(x), j_cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert idx[0].tolist() == list(range(cfg.top_k))


def test_expert_ffn_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    wg, wu = (rng.standard_normal((3, D, 16)).astype(np.float32)
              for _ in range(2))
    wo = rng.standard_normal((3, 16, D)).astype(np.float32)
    got = moe._expert_ffn(*(torch.from_numpy(a) for a in (wg, wu, wo, x)))
    want = j_moe._expert_ffn(*(jnp.asarray(a) for a in (wg, wu, wo, x)))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_f32(name):
    cfg = CASES[name]
    j_cfg, params, port = _pair(cfg)
    x = _x((2, 7, D))
    out, aux = moe.moe_ffn(port, torch.from_numpy(x), cfg)
    j_out, j_aux = j_moe.moe_ffn(params, jnp.asarray(x), j_cfg, impl="dense")
    assert out.shape == (2, 7, D)
    _close(out.numpy(), np.asarray(j_out))
    _close(aux.numpy(), np.asarray(j_aux))
    dense, _ = moe.moe_ffn(port, torch.from_numpy(x), cfg, impl="dense")
    assert torch.equal(dense, out)  # auto is the dense path on the port


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_bf16(name):
    cfg = CASES[name]
    j_cfg, params, port = _pair(cfg, dtype=torch.bfloat16)
    x = _x((2, 7, D))
    out, aux = moe.moe_ffn(port, torch.from_numpy(x).bfloat16(), cfg)
    j_out, j_aux = j_moe.moe_ffn(params, jnp.asarray(x).astype(jnp.bfloat16),
                                 j_cfg, impl="dense")
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert _rel_l2(_np(out), _np(j_out)) < BF16_REL
    assert abs(float(aux) - float(j_aux)) < BF16_REL * abs(float(j_aux))


def test_shared_experts_are_gated_in():
    """Zeroing the shared experts' gate weight halves their output
    (sigmoid(0)); removing the routed output leaves exactly that."""
    cfg = CASES["qwen2-moe-smoke"]
    _, _, port = _pair(cfg)
    x = torch.from_numpy(_x((1, 3, D)))
    with torch.no_grad():
        port.shared.gate.zero_()
        port.wo.zero_()
    out, _ = moe.moe_ffn(port, x, cfg)
    from repro_torch.models.common import mlp
    sh = port.shared
    want = 0.5 * mlp(sh.wi_gate, sh.wi_up, sh.wo, x.reshape(3, D))
    torch.testing.assert_close(out.reshape(3, D), want, rtol=0, atol=0)


def test_ep_raises_and_never_runs_dense():
    """``impl="ep"`` (ported since expert parallelism was) needs a
    dispatch mesh with a ``model`` axis and serves only: without a mesh
    it raises, under autograd it raises naming ROADMAP, and neither falls
    back to the dense path."""
    from repro_torch.distributed.sharding import ShardCtx, train_act_rules
    from repro_torch.launch.mesh import Mesh

    cfg = CASES["phi3.5-moe-smoke"]
    _, _, port = _pair(cfg)
    mesh = Mesh(("data", "model"), (1, 2), (torch.device("cpu"),) * 2)
    ctx = ShardCtx(mesh, train_act_rules(mesh))
    calls = []
    orig = moe._dense_moe
    try:
        moe._dense_moe = lambda *a: calls.append(1) or orig(*a)
        with pytest.raises(ValueError, match="needs ctx.mesh"):
            moe.moe_ffn(port, torch.zeros(1, 2, D), cfg, impl="ep")
        x = torch.zeros(1, 2, D, requires_grad=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            moe.moe_ffn(port, x, cfg, ctx=ctx, impl="ep")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            moe.moe_ffn(port, x, cfg, ctx=ctx)  # auto picks ep on the mesh
        with pytest.raises(ValueError, match="unknown MoE impl"):
            moe.moe_ffn(port, torch.zeros(1, 2, D), cfg, impl="sparse")
    finally:
        moe._dense_moe = orig
    assert calls == []
