"""xLSTM LM, ported from ``repro/models/xlstm.py``: alternating mLSTM
(even layers, chunkwise parallel) and sLSTM (odd layers, a true
recurrence) blocks with residuals and no FFN (``d_ff = 0``).

The layers are heterogeneous, so ``params["layers"]`` is a LIST of
per-layer dicts (``{"norm", "mixer"}``), not stacked leaves: the tree
flattens it by index, as JAX does.  The cache is a list of per-layer
states (``MLSTMState`` / ``SLSTMState``), O(1) in the sequence length;
:func:`decode_step` returns new states (the reference's).  The reference
applies no remat to this family; neither does the port.  The
tensor-parallel form (:func:`loss_fn_tp`) runs every local rank of a ``D
x M`` mesh together, each mixer on its rank's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import tree as T
from . import attention as attn
from . import sharding as shd
from . import ssm
from . import transformer as tfm
from .config import ModelConfig
from .layers import cross_entropy_loss, dtype_of, init_leaf, rmsnorm


def _is_mlstm(i: int) -> bool:
    return i % 2 == 0


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's leaves)."""
    d = cfg.d_model
    layers = [{"norm": (d,), "mixer": (ssm.mlstm_shapes(cfg) if _is_mlstm(i)
                                       else ssm.slstm_shapes(cfg))}
              for i in range(cfg.n_layers)]
    return {"embed": (cfg.vocab_size, d), "layers": layers,
            "final_norm": (d,), "lm_head": (d, cfg.vocab_size)}


def leaf_dtype(cfg: ModelConfig, path) -> torch.dtype:
    return dtype_of(cfg)


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None,
                split=None) -> dict | list:
    """Random parameters from ``gen``, each leaf by the reference's
    initializer for its name (:func:`layers.init_leaf`).  With
    ``split(path, leaf)``, one tree of blocks per rank
    (``transformer.split_draws``)."""
    dtype = dtype_of(cfg)
    draws = ((path, init_leaf(gen, path[-1], shape, 0, dtype, device))
             for path, shape in T.flatten(param_shapes(cfg)))
    if split is None:
        return T.unflatten(draws)
    return tfm.split_draws(draws, split)


def _forward(params, cfg, x, states=None):
    new_states = []
    for i, lp in enumerate(params["layers"]):
        h = rmsnorm(x, lp["norm"], cfg.norm_eps)
        st = states[i] if states is not None else None
        mixer = ssm.mlstm_forward if _is_mlstm(i) else ssm.slstm_forward
        y, ns = mixer(lp["mixer"], cfg, h, state=st)
        x = x + y
        new_states.append(ns)
    return x, new_states


def _embed(params, cfg, tokens):
    return F.embedding(tokens.long(), params["embed"]).to(dtype_of(cfg))


def _head(params, cfg, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype)


def forward_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = True):
    """(B, S) token ids to (B, S, V) logits."""
    x, _ = _forward(params, cfg, _embed(params, cfg, tokens))
    return _head(params, cfg, x)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            remat: bool = True) -> torch.Tensor:
    return cross_entropy_loss(forward_logits(params, cfg, batch["tokens"]),
                              batch["targets"], batch.get("mask"))


def _layer_tp(cfg, tp, i: int, paths, lls, nr: int, *args):
    """Layer ``i`` (mLSTM or sLSTM) for all local ranks: ``args`` is the
    ranks' streams, then each rank's layer leaves in ``paths`` order."""
    ax = tp.axis
    xs, leaves = args[:nr], args[nr:]
    n = len(paths)
    lp = tfm._leaf_acts(tp, paths, lls,
                        [leaves[r * n:(r + 1) * n] for r in range(nr)], 0)
    x = shd.Act(xs, "btd", tfm._stream(tp))
    h = attn._norm_tp(ax, x, lp["norm"], cfg.norm_eps)
    mixer = ssm.mlstm_forward_tp if _is_mlstm(i) else ssm.slstm_forward_tp
    return tuple(tfm._add(x, shd.act_btd(mixer(ax, lp["mixer"], cfg, h),
                                         ax)).xs)


def loss_fn_tp(params: list, cfg: ModelConfig, batches: list, tp,
               remat: bool = True) -> list:
    """Per-rank losses of the xLSTM over the local ranks of a
    tensor-parallel mesh (``transformer.loss_fn_tp``'s contract): every
    mixer runs its own heads on each rank (``ssm.mlstm_forward_tp``,
    ``ssm.slstm_forward_tp``), its input gathered whole over the
    sequence where the stream is split on it (sequence parallelism: the
    reference's ``act_btd`` splits it only between layers).  ``remat`` is
    unused: the reference applies none to this family, nor does
    :func:`loss_fn`."""
    nr = len(params)
    top = tfm._top_tp(tp, params)
    x, _ = tfm._embed_stream_tp(cfg, tp, top, batches)
    for i in range(cfg.n_layers):
        items = [T.flatten(p["layers"][i]) for p in params]
        paths = [path for path, _ in items[0]]
        lls = [T.get(tp.layout.leaves["layers"][i], path) for path in paths]
        leaves = [leaf for it in items for _, leaf in it]
        x = shd.Act(_layer_tp(cfg, tp, i, paths, lls, nr, *x.xs, *leaves),
                    "btd", x.layout)
    return tfm._loss_head_tp(cfg, tp, top, x, batches)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list:
    """Zero states, one per layer (``max_len`` is unused: O(1) state)."""
    return [ssm.mlstm_init_state(cfg, batch, device) if _is_mlstm(i)
            else ssm.slstm_init_state(cfg, batch, device)
            for i in range(cfg.n_layers)]


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int):
    """``(states, logits (B, V))`` of the last prompt token."""
    x, states = _forward(params, cfg, _embed(params, cfg, tokens))
    return states, _head(params, cfg, x[:, -1])


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: list, token, pos):
    """One token per row (``pos`` is unused: the states carry it)."""
    dev = params["embed"].device
    x = _embed(params, cfg, torch.as_tensor(token, device=dev))[:, None]
    x, states = _forward(params, cfg, x, states=cache)
    return states, _head(params, cfg, x[:, 0])
