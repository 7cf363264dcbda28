"""The hybrid family (hymba: attention and Mamba heads in parallel) in
the port, at 6 layers with global layers 0, 3 and 5 and a sequence of
24 (window 8, three Mamba chunks of 8), held against the reference as
``test_torch_archs.py`` holds the decoders (the cases and tolerances
are in ``_torch_arch_cases.py``).
"""
import pytest

import _torch_arch_cases as AC
from _torch_arch_cases import (  # noqa: F401
    one_torch_thread, test_full_config_matches_reference,
    test_leaf_order_matches_jax, test_logits_match_reference,
    test_loss_and_grads_match_reference,
    test_prefill_and_decode_match_reference,
    test_prefill_plus_decode_equals_forward)

ARCHS = ["hymba-1.5b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return AC.load_case(request.param)
