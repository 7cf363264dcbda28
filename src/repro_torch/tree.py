"""Nested parameter trees, flattened in the JAX package's leaf order.

The port keeps the reference's parameter layout at every public boundary:
dicts and lists whose leaves are tensors (or numpy arrays).  JAX
flattens a dict by sorted key and a list by index (0, 1, 2, ..., 10,
11: not the string order 0, 1, 10, 11, 2), and so do these helpers, so
a leaf index means the same leaf in both packages and sums over leaves
run in the same order.  A path is a tuple of keys: a ``str`` for a dict
entry, an ``int`` for a list entry (xLSTM's ``params["layers"]``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Path = tuple[str | int, ...]


def flatten(tree) -> list[tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in JAX's order: dicts by sorted key, lists
    by index."""
    out: list[tuple[Path, Any]] = []
    _walk(tree, (), out)
    return out


def _walk(node, prefix: Path, out: list) -> None:
    # A module-level function: a nested recursive one would close over
    # itself, a reference cycle that keeps ``out`` (every leaf of the
    # tree, device memory included) alive until the cyclic collector runs.
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], prefix + (k,), out)
    elif isinstance(node, list):
        for i, child in enumerate(node):
            _walk(child, prefix + (i,), out)
    else:
        out.append((prefix, node))


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten(tree)]


def unflatten(items) -> dict:
    """Inverse of :func:`flatten` (``items`` of ``(path, leaf)``)."""
    root: dict = {}
    for path, leaf in items:
        assign(root, path, leaf)
    return root


def get(tree, path: Path):
    """The leaf at ``path``."""
    node = tree
    for k in path:
        node = node[k]
    return node


def assign(tree, path: Path, value) -> None:
    """Set the leaf at ``path``, creating inner nodes as needed: a list
    where the next key is an ``int``, else a dict."""
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        node = _child(node, k, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        node.extend([None] * (path[-1] + 1 - len(node)))
    node[path[-1]] = value


def _child(node, k, empty):
    """``node[k]``, set to ``empty`` first when missing (a list grows to
    hold index ``k``)."""
    if isinstance(node, list):
        node.extend([None] * (k + 1 - len(node)))
        if node[k] is None:
            node[k] = empty
        return node[k]
    return node.setdefault(k, empty)


def map_leaves(fn: Callable, tree):
    """A tree of the same structure with ``fn`` applied to every leaf."""
    return unflatten((path, fn(leaf)) for path, leaf in flatten(tree))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors: shape, dtype and raw bytes
    (bfloat16, signed zeros and NaN payloads compared as bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))
