"""The whole-model parity tests of ``test_torch_lm_model.py`` for
the recurrent archs (xLSTM, RecurrentGemma) and the stubbed frontends (MusicGen's frames, PaliGemma's image prefix).  The tolerances and their reasons are stated there."""
import pytest

from test_torch_lm_model import run_case
from test_torch_lm_model import test_decode_step_caches  # noqa: F401
from test_torch_lm_model import test_decode_step_logits  # noqa: F401
from test_torch_lm_model import test_engine_greedy_matches_reference  # noqa: F401,E501
from test_torch_lm_model import test_forward_logits  # noqa: F401
from test_torch_lm_model import test_loss_value  # noqa: F401
from test_torch_lm_model import test_prefill_last_position  # noqa: F401


@pytest.fixture(scope="module", params=["xlstm_1_3b", "recurrentgemma_2b", "musicgen_medium", "paligemma_3b"])
def case(request):
    return run_case(request.param)
