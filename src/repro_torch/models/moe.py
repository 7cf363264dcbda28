"""Token-choice top-k MoE — parameter init and the dispatch-mode router.

Ported from ``repro/models/moe.py``.  The stages live in
:mod:`repro_torch.models.dispatch`; this module initializes the MoE
parameter subtree and selects the layout from ``cfg.moe_dispatch``:
``global`` (one flat token pool) and ``rowwise`` (per-sequence pools,
:func:`dispatch.moe_ffn_rowwise`) here, and over a model axis
(:func:`moe_ffn_tp`), ``ep`` (expert parallelism over
a communicator's ranks) through :func:`dispatch.moe_ffn_ep`, which works
on all of a communicator's local ranks at once and so is called by the
ep forward of :mod:`repro_torch.models.transformer`.
"""
from __future__ import annotations

import torch

from .dispatch import (capacity, moe_ffn_ep, moe_ffn_global,  # noqa: F401
                       moe_ffn_global_tp, moe_ffn_rowwise,
                       moe_ffn_rowwise_tp)
from .layers import dense_init


def moe_shapes(cfg) -> dict:
    """Shapes of one layer's MoE subtree (the reference's ``init_moe``)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
            "w_down": (e, ff, d)}


def moe_draws(gen: torch.Generator, cfg, dtype, device=None,
              n_layers: int | None = None):
    """Random MoE parameters from ``gen``, ``(name, leaf)`` in the
    reference's ``init_moe`` order: a float32 router of std 0.02 and
    expert weights in ``dtype`` with the reference's fan-in (the leading
    dim of each ``(E, ...)`` leaf, as its ``dense_init`` takes it).  With
    ``n_layers``, every leaf is stacked ``(n_layers, ...)``."""
    lead = () if n_layers is None else (n_layers,)
    for name, shape in moe_shapes(cfg).items():
        if name == "router":
            yield name, dense_init(gen, lead + shape, torch.float32,
                                   fan_in=shape[0], std=0.02, device=device)
        else:
            yield name, dense_init(gen, lead + shape, dtype,
                                   fan_in=shape[0], device=device)


def moe_ffn(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, d) → (out (B, S, d), aux loss): one flat pool
    (``global``) or one pool per sequence (``rowwise``).  The ``ep``
    layout exchanges across ranks and runs through :func:`moe_ffn_ep`
    over all of them at once."""
    mode = _mode(cfg)
    if mode == "global":
        return moe_ffn_global(p, cfg, x)
    return moe_ffn_rowwise(p, cfg, x)


def _mode(cfg) -> str:
    mode = getattr(cfg, "moe_dispatch", "global")
    if mode == "ep":
        raise ValueError("moe_dispatch='ep' exchanges across ranks: run it "
                         "through moe_ffn_ep over a communicator")
    if mode not in ("global", "rowwise"):
        raise ValueError(f"unknown moe_dispatch {mode!r}; have "
                         f"['ep', 'global', 'rowwise']")
    return mode


def moe_ffn_tp(ax, p: dict, cfg, x, data=None):
    """:func:`moe_ffn` over a model axis (``ax``; ``p`` each leaf's
    per-rank blocks, ``x`` an ``Act``): ``(Act of partial sums, per-rank
    aux)``.  ``data``: the data axis whose ranks pool their tokens
    (fsdp_auto's global dispatch)."""
    if _mode(cfg) == "global":
        return moe_ffn_global_tp(ax, p, cfg, x, data)
    return moe_ffn_rowwise_tp(ax, p, cfg, x)
