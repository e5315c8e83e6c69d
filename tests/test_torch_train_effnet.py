"""EfficientNet's training gradients at the smoke config's 64² against
``jax.value_and_grad`` on the CPU (``test_torch_train.py``'s helpers).
At 64² its last stages normalise over 2 × 2 × 2 values, whose batch
statistics amplify bf16 rounding: each framework's bf16 gradients lie
about 0.4 tree relative L2 from the f32 ones (the JAX model's own 0.35,
the port's 0.38) and 0.41 from each other, where at 224² all three gaps
are 0.03-0.04 (``test_torch_train_conv.py``).  So f32 is held to the
usual bars, and bf16 to the JAX model's own bf16 error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (_batch, _grads, _setup,  # noqa: E402
                              _torch_batch, _tree_rel, check_loss_and_grads,
                              j_loss, t_loss)


def test_effnet_smoke_res_loss_and_grads_match_jax():
    check_loss_and_grads("effnet", "float32")


def test_effnet_smoke_res_bf16_error_is_the_references_own():
    """At 64² in bf16: the port's gradients are no farther from the f32
    ones than 1.25 times the JAX model's own bf16 gradients are."""
    arch, jarch, model, params = _setup("effnet")
    nb = _batch("effnet", arch)
    grad = jax.jit(jax.grad(lambda p, b, dt: j_loss("effnet", jarch, p, b, dt),
                            argnums=0), static_argnums=2)
    jb = jax.tree_util.tree_map(jnp.asarray, nb)
    exact, j_bf16 = grad(params, jb, jnp.float32), grad(params, jb,
                                                         jnp.bfloat16)
    t_loss("effnet", arch, model, _torch_batch(nb), torch.bfloat16).backward()
    ours, theirs = _tree_rel(_grads(model), exact), _tree_rel(j_bf16, exact)
    assert theirs > 0.1  # the conditioning the module docstring names
    assert ours <= 1.25 * theirs, (ours, theirs)
    assert all(np.any(g != 0) for g in jax.tree_util.tree_leaves(
        _grads(model)))
