"""The qwen3 decoders of the reference (qk-norm) in the port: ``qwen3-4b``
and ``qwen3-1.7b``, scaled down (to one config, whose reference results
are computed once), held against the reference from shared weights: full
config and parameter tree, leaf order, loss and gradients, logits,
prefill caches and decode logits, and prefill + decode against
``forward_logits``. The cases and tolerances are in
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

ARCHS = ["qwen3-4b", "qwen3-1.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return AC.load_case(request.param)
