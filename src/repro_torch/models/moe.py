"""Token-choice top-k MoE — parameter init and the dispatch-mode router.

Ported from ``repro/models/moe.py``.  The stages live in
:mod:`repro_torch.models.dispatch`; this module initializes the MoE
parameter subtree and selects the layout from ``cfg.moe_dispatch``:
``global`` (one flat token pool) here, ``ep`` (expert parallelism over a
communicator's ranks) through :func:`dispatch.moe_ffn_ep`, which works
on all of a communicator's local ranks at once and so is called by the
ep forward of :mod:`repro_torch.models.transformer`.  ``rowwise`` is not
ported yet (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import torch

from .dispatch import capacity, moe_ffn_ep, moe_ffn_global  # noqa: F401
from .layers import dense_init


def moe_shapes(cfg) -> dict:
    """Shapes of one layer's MoE subtree (the reference's ``init_moe``)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
            "w_down": (e, ff, d)}


def init_moe(gen: torch.Generator, cfg, dtype, device=None,
             n_layers: int | None = None) -> dict:
    """Random MoE parameters from ``gen``: a float32 router of std 0.02
    and expert weights in ``dtype`` with the reference's fan-in (the
    leading dim of each ``(E, ...)`` leaf, as its ``dense_init`` takes
    it).  With ``n_layers``, every leaf is stacked ``(n_layers, ...)``."""
    lead = () if n_layers is None else (n_layers,)
    out = {}
    for name, shape in moe_shapes(cfg).items():
        if name == "router":
            out[name] = dense_init(gen, lead + shape, torch.float32,
                                   fan_in=shape[0], std=0.02, device=device)
        else:
            out[name] = dense_init(gen, lead + shape, dtype,
                                   fan_in=shape[0], device=device)
    return out


def moe_ffn(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, d) → (out (B, S, d), aux loss) on one flat pool.  The
    ``ep`` layout exchanges across ranks and runs through
    :func:`moe_ffn_ep` over all of them at once."""
    mode = getattr(cfg, "moe_dispatch", "global")
    if mode == "global":
        return moe_ffn_global(p, cfg, x)
    if mode == "ep":
        raise ValueError("moe_dispatch='ep' exchanges across ranks: run it "
                         "through moe_ffn_ep over a communicator")
    if mode == "rowwise":
        raise NotImplementedError("moe_dispatch='rowwise' is not ported yet "
                                  "(ROADMAP.md queue 1 item 8)")
    raise ValueError(f"unknown moe_dispatch {mode!r}; have "
                     f"['ep', 'global', 'rowwise']")
