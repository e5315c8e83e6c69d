"""The training losses and gradients of the UNet, the ViT and
EfficientNet against ``jax.value_and_grad`` on the CPU (the helpers and
bars of ``test_torch_train.py``; a file of their own, each compile a few
seconds).  EfficientNet runs here at its train shape's 224², where its
bf16 gradients meet the 5e-2 bar; its smoke config's 64² is
``test_torch_train_effnet.py``'s."""

import pytest

pytest.importorskip("torch")

from test_torch_train import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fam,res", [("unet", None), ("vit", None),
                                     ("effnet", 224)],
                         ids=["unet", "vit", "effnet"])
def test_loss_and_grads_match_jax(fam, res, dtype):
    check_loss_and_grads(fam, dtype, res=res)
