"""The other five smoke architectures of tests/test_torch_train_grad_a.py
(loss and flat gradient against the reference op by op; tolerances there)."""
import pytest

pytest.importorskip("jax")
from test_torch_train_grad_a import _one_thread, check_loss_and_grad  # noqa: E402,F401

ARCHS = ["deepseek-v2-236b", "llama4-maverick-400b-a17b", "pixtral-12b", "rwkv6-1.6b", "minitron-4b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_flat_gradient_match_reference(arch):
    check_loss_and_grad(arch)
