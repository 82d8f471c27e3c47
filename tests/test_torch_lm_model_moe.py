"""The whole-model parity tests of ``test_torch_lm_model.py`` for
the MoE archs (DeepSeekMoE with its dense first layer and shared experts, Grok with its softcap), on float32 parameters.  The tolerances and their reasons are stated there."""
import pytest

from test_torch_lm_model import run_case
from test_torch_lm_model import test_decode_step_caches  # noqa: F401
from test_torch_lm_model import test_decode_step_logits  # noqa: F401
from test_torch_lm_model import test_engine_greedy_matches_reference  # noqa: F401,E501
from test_torch_lm_model import test_forward_logits  # noqa: F401
from test_torch_lm_model import test_loss_value  # noqa: F401
from test_torch_lm_model import test_prefill_last_position  # noqa: F401


@pytest.fixture(scope="module", params=["deepseek_moe_16b", "grok_1_314b"])
def case(request):
    return run_case(request.param)
