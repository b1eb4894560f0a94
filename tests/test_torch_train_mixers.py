"""The port's train step against the JAX package's at the reduced MoE, SSD
and RG-LRU configs in f32 (the rest: ``test_torch_train_step.py`` and
``test_torch_train_attention.py``): ``loss_fn``'s loss and every gradient
leaf against ``jax.value_and_grad`` of the reference's, and one
``make_train_step`` step under the first-step rule (``_train_parity``)."""
import pytest
import torch

from _train_parity import check_first_step, check_loss_and_grads

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

ARCHS = ("granite_moe_3b_a800m", "dbrx_132b", "mamba2_370m",
         "recurrentgemma_2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_are_the_references(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_is_the_references(arch):
    check_first_step(arch)
