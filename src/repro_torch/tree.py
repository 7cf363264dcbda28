"""Nested-dict parameter trees, flattened in the JAX package's leaf order.

The port keeps the reference's parameter layout at every public boundary:
a dict of dicts whose leaves are tensors (or numpy arrays).  JAX
flattens a dict by sorted key, and so do these helpers, so a leaf index
means the same leaf in both packages and sums over leaves run in the same
order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Path = tuple[str, ...]


def flatten(tree: dict) -> list[tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in sorted-key (JAX) order."""
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
    else:
        out.append((prefix, node))


def leaves(tree: dict) -> list:
    """The leaves of ``tree`` in sorted-key (JAX) order."""
    return [leaf for _, leaf in flatten(tree)]


def unflatten(items) -> dict:
    """Inverse of :func:`flatten` (``items`` of ``(path, leaf)``)."""
    root: dict = {}
    for path, leaf in items:
        assign(root, path, leaf)
    return root


def get(tree: dict, path: Path):
    """The leaf at ``path``."""
    node = tree
    for k in path:
        node = node[k]
    return node


def assign(tree: dict, path: Path, value) -> None:
    """Set the leaf at ``path`` (creating inner dicts as needed)."""
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def map_leaves(fn: Callable, tree: dict) -> dict:
    """A tree of the same structure with ``fn`` applied to every leaf."""
    return unflatten((path, fn(leaf)) for path, leaf in flatten(tree))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors: shape, dtype and raw bytes
    (bfloat16, signed zeros and NaN payloads compared as bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))
