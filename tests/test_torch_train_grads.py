"""The port's training loss and gradients (`repro_torch.train.train_step`)
against the JAX package's, on the CPU: the dense text configs and the
audio and vision frontends (the MoE and SSM configs are in
`test_torch_train_grads_moe_ssm.py`; the JAX gradient compiles of all ten
take ~80 s in one file).

For each config at `reduced()` width, fp32 activations: the reference's
parameters (carried across with `convert.lm_params_from_jax`) and one
numpy batch go through `jax.value_and_grad(repro.train.train_step.loss_fn)`
and through the port's `loss_fn` and `torch.autograd.grad`; the port's
gradients come back in the reference's structure through
`convert.lm_params_to_jax`, leaf for leaf in flatten order, with the same
paths (`_torch_lm.check_loss_and_grads`). Both sides remat (the
reference's `jax.checkpoint` of each repeat, the port's
`torch.utils.checkpoint` of each layer) and take the CE in chunks of 8
positions.

Tolerance: the loss, CE and MoE aux within 1e-5 absolute (measured: 0 to
9.5e-7); each gradient leaf within 1e-4 of the largest magnitude in the
reference's leaf (measured: at most 1.7e-5, at zamba2's `A_log`; XLA and
PyTorch sum the products in other orders).
"""

import pytest
import torch

from _torch_lm import check_loss_and_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["gemma3-1b", "gemma2-2b", "h2o-danube-1.8b", "gemma3-27b",
                                  "musicgen-large", "internvl2-2b"])
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)
