"""The gradient parity tests of ``test_torch_train_grads.py`` for the
mixed-block archs (RecurrentGemma, xLSTM).  The tolerances and their
reasons are stated there."""
import pytest

from test_torch_train_grads import grad_case
from test_torch_train_grads import test_grads_leaf_by_leaf  # noqa: F401
from test_torch_train_grads import test_loss_matches  # noqa: F401


@pytest.fixture(scope="module", params=["recurrentgemma_2b", "xlstm_1_3b"])
def case(request):
    return grad_case(request.param)
