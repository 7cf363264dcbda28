"""The multimodal architectures of the reference in the port:
``whisper-small`` (encoder frames) and ``llama-3.2-vision-90b`` (at 10
layers: two groups; image embeddings), scaled down, held against the
reference from shared weights as ``test_torch_archs.py`` holds the
decoders (the cases and tolerances are in ``_torch_arch_cases.py``);
and trees with a list node (the xLSTM's layers).
"""
import random

import jax
import numpy as np
import pytest

import _torch_arch_cases as AC
from _torch_arch_cases import (  # noqa: F401
    one_torch_thread, test_full_config_matches_reference,
    test_leaf_order_matches_jax, test_logits_match_reference,
    test_loss_and_grads_match_reference,
    test_prefill_and_decode_match_reference,
    test_prefill_plus_decode_equals_forward)
from repro.configs import ALIASES, get_config
from repro.models import build
from repro_torch import tree as T
from repro_torch.checkpoint.manager import treedef_str

ARCHS = [a for a in ALIASES if get_config(a).family in ("encdec", "vlm")]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return AC.load_case(request.param)


def test_list_tree_round_trips_in_any_order():
    """``tree.unflatten`` rebuilds a tree with a list node from its items
    in any order (the string order 0, 1, 10, 11, 2, ... included),
    ``map_leaves`` keeps the lists, and ``treedef_str`` is JAX's
    ``str(treedef)`` of the same tree (the checkpoint manifest's)."""
    cfg = AC.scaled("xlstm-125m")
    shapes = jax.eval_shape(build(cfg, recipe=None).init,
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    items = T.flatten(tree)
    idx = [p[1] for p, _ in items if p[0] == "layers"]
    assert idx == sorted(idx) and set(idx) == set(range(12))
    for order in (sorted(items, key=lambda it: ".".join(map(str, it[0]))),
                  random.Random(0).sample(items, len(items))):
        back = T.unflatten(order)
        assert isinstance(back["layers"], list) and len(back["layers"]) == 12
        assert [p for p, _ in T.flatten(back)] == [p for p, _ in items]
    mapped = T.map_leaves(lambda x: x.shape, tree)
    assert isinstance(mapped["layers"], list)
    assert treedef_str(tree) == str(jax.tree.structure(tree))
