"""Dense decoders of the reference in the port: ``internlm2-1.8b`` and
``qwen1.5-110b`` (QKV bias), scaled down, held against the reference
from shared weights: full config and parameter tree, leaf order, loss
and gradients, logits, prefill caches and decode logits, and prefill +
decode against ``forward_logits``. The cases and tolerances are in
``_torch_arch_cases.py``; each file holds two or fewer archs, so that no
one file holds a test worker long.
"""
import pytest

import _torch_arch_cases as AC
from _torch_arch_cases import (  # noqa: F401
    one_torch_thread, test_full_config_matches_reference,
    test_leaf_order_matches_jax, test_logits_match_reference,
    test_loss_and_grads_match_reference,
    test_prefill_and_decode_match_reference,
    test_prefill_plus_decode_equals_forward)

ARCHS = ["internlm2-1.8b", "qwen1.5-110b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return AC.load_case(request.param)
