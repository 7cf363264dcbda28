"""Decoder-only LM, dense, MoE and hybrid (hymba) families, ported from
``repro/models/transformer.py``.

Parameters keep the reference's layout: a nested dict whose layer
weights are STACKED along a leading ``n_layers`` axis (``layers.attn.wq``
is ``(L, d, H, dh)``, ``layers.ffn.w_gate`` is ``(L, d, d_ff)``), because
ZeRO-1 shards each leaf along dim 0 and must pad, shard and hand the
kernel the same shapes as the reference.  The forward pass loops over
the layer index (the reference's ``lax.scan``) and, with ``remat``,
recomputes each layer in the backward pass (``torch.utils.checkpoint``
in place of ``jax.checkpoint``).  The MoE family replaces each layer's
FFN by the ``moe`` subtree (a float32 router and stacked expert weights)
and adds the layers' load-balancing aux losses to the loss.  The hybrid
family (hymba) runs attention heads and Mamba heads in parallel on the
same normed input and mixes them through per-branch RMS norms
(``norm_attn_out``, ``norm_ssm_out``); its attention is a sliding window
except on ``global_attn_layers``.  The reference unrolls those layers
and scans the runs between them (``_hybrid_runs``) to keep each window
static; here every layer runs in a loop anyway, so each takes its
window from its index.  QKV bias (qwen1.5) is the attention's
``bq``/``bk``/``bv``.  The MoE family's
expert-parallel form (``moe_dispatch="ep"``) runs every layer for all of
a communicator's local ranks together (:func:`loss_fn_ep`): attention per
rank, then one MoE exchange across them, each layer one checkpoint around
all ranks.  The cache paths serve: :func:`prefill` runs a prompt and
fills an ``(L, B, max_len, Hkv, dh)`` KV cache (:func:`init_cache`; the
hybrid family's also holds each layer's ``MambaState``), returning the
last token's logits only, and :func:`decode_step` runs one token per row
at one offset or at a per-row offset, writing its k/v (and Mamba state)
into the cache in place.  Their expert-parallel forms
(:func:`prefill_ep`, :func:`decode_step_ep`) run every local rank of a
communicator on the same tokens, each layer's MoE exchange across them.
The dense, MoE and hybrid families' tensor-parallel form
(:func:`loss_fn_tp`) runs every local rank of a ``D x M`` mesh
together, each rank with its blocks of the leaves
(``models/sharding.py``): attention and FFN through the reference's
hooks (the MoE's global or rowwise dispatch with each rank's experts,
``dispatch.moe_ffn_global_tp``; the hybrid's Mamba heads on each rank's
inner channels, ``ssm.mamba_forward_tp``), the embedding a
vocab-parallel lookup, the head vocab-sharded logits and the loss a
vocab-parallel cross-entropy; under fsdp_auto each layer's leaves split
over the data axis are gathered just before the layer runs (again in
its recompute) and freed after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import tree as T
from . import attention as attn
from . import sharding as shd
from . import ssm
from .config import ModelConfig
from .layers import (cross_entropy_loss, dtype_of, ffn, init_leaf,
                     layer_slices, rmsnorm, run_layer)
from .moe import moe_draws, moe_ffn, moe_ffn_ep, moe_ffn_tp, moe_shapes

FAMILIES = ("dense", "moe", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.is_moe != (cfg.family == "moe"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with "
                         f"{cfg.n_experts} experts is not a decoder-only "
                         f"family of this module {FAMILIES}")


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's leaves)."""
    _check_family(cfg)
    L, d = cfg.n_layers, cfg.d_model

    def stack(shapes: dict) -> dict:
        return {k: (L, *v) for k, v in shapes.items()}

    layers = {"norm1": (L, d), "norm2": (L, d),
              "attn": stack(attn.attention_shapes(cfg))}
    if cfg.family == "hybrid":
        layers.update(mamba=stack(ssm.mamba_shapes(cfg)),
                      norm_attn_out=(L, d), norm_ssm_out=(L, d))
    if cfg.is_moe:
        layers["moe"] = stack(moe_shapes(cfg))
    elif cfg.d_ff > 0:
        layers["ffn"] = stack({"w_gate": (d, cfg.d_ff),
                               "w_up": (d, cfg.d_ff),
                               "w_down": (cfg.d_ff, d)})
    shapes = {"embed": (cfg.vocab_size, d), "layers": layers,
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def leaf_dtype(cfg: ModelConfig, path) -> torch.dtype:
    """A leaf's dtype: ``cfg.dtype``, but float32 for the MoE router, as
    the reference keeps it."""
    return torch.float32 if path[-1] == "router" else dtype_of(cfg)


def _draws(cfg: ModelConfig, gen: torch.Generator, device):
    """``(path, leaf)`` in the order :func:`init_params` draws them from
    ``gen``: every leaf by :func:`layers.init_leaf`, then the MoE
    subtree."""
    dtype = dtype_of(cfg)
    for path, shape in T.flatten(param_shapes(cfg)):
        if path[:2] != ("layers", "moe"):
            yield path, init_leaf(gen, path[-1], shape,
                                  int(path[0] == "layers"), dtype, device)
    if cfg.is_moe:
        for name, leaf in moe_draws(gen, cfg, dtype, device,
                                    n_layers=cfg.n_layers):
            yield ("layers", "moe", name), leaf


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None,
                split=None) -> dict | list:
    """Random parameters from ``gen`` (on ``gen``'s device), each leaf by
    the reference's initializer for its name (:func:`layers.init_leaf`;
    fan-in of the per-layer shape).  With ``split(path, leaf)``, a list
    of per-rank blocks of a whole leaf, it returns one tree per rank:
    each leaf is drawn whole, as the unsharded model draws it from the
    same generator, cut into its blocks and freed (not the
    expert-parallel MoE: :func:`check_tp`)."""
    if split is None:
        return T.unflatten(_draws(cfg, gen, device))
    check_tp(cfg)
    return split_draws(_draws(cfg, gen, device), split)


def split_draws(draws, split) -> list:
    """One tree per rank from ``(path, whole leaf)`` draws, each leaf cut
    into its blocks by ``split(path, leaf)`` and freed."""
    trees = None
    for path, leaf in draws:
        blocks = split(path, leaf)
        del leaf
        trees = trees or [{} for _ in blocks]
        for tree, b in zip(trees, blocks):
            T.assign(tree, path, b)
    return trees


def _window(cfg: ModelConfig, i: int) -> int:
    """Layer ``i``'s attention window (0: full): the hybrid family's
    global layers attend over everything."""
    if cfg.family == "hybrid" and i in cfg.global_attn_layers:
        return 0
    return cfg.sliding_window


def _mixer_block(cfg: ModelConfig, lp: dict, x, positions, i: int):
    """``(x + mixer, (k, v), MambaState | None)``: attention, and for the
    hybrid family Mamba heads on the same normed input, mixed 50/50
    after their own norms."""
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    a, kv = attn.self_attention(lp["attn"], cfg, h, positions,
                                window=_window(cfg, i))
    if cfg.family != "hybrid":
        return x + a, kv, None
    m, mstate = ssm.mamba_forward(
        lp["mamba"], cfg, h, chunk=min(cfg.mlstm_chunk, h.shape[1]))
    return x + _hybrid_mix(cfg, lp, a, m), kv, mstate


def _hybrid_mix(cfg: ModelConfig, lp: dict, a, m):
    return 0.5 * (rmsnorm(a, lp["norm_attn_out"], cfg.norm_eps)
                  + rmsnorm(m, lp["norm_ssm_out"], cfg.norm_eps))


def _layer_forward(cfg: ModelConfig, paths, i: int, x, positions, *leaves):
    """Layer ``i``: ``x`` for the dense and hybrid families, ``(x, aux)``
    for MoE."""
    lp = T.unflatten(zip(paths, leaves))
    x, _, _ = _mixer_block(cfg, lp, x, positions, i)
    if cfg.d_ff == 0 and not cfg.is_moe:
        return x
    h = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_ffn(lp["moe"], cfg, h)
        return x + y, aux
    return x + ffn(lp["ffn"], h)


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    b, s = tokens.shape
    x = F.embedding(tokens.long(), params["embed"]).to(dtype_of(cfg))
    return x, torch.arange(s, device=x.device).expand(b, s)


def _head(params: dict, cfg: ModelConfig, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = True):
    """(B, S) token ids to (B, S, V) logits in the parameter dtype, and
    for the MoE family the summed aux loss: ``(logits, aux)``."""
    _check_family(cfg)
    x, positions = _embed(params, cfg, tokens)
    paths, per_layer = layer_slices(params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        out = run_layer(_layer_forward, remat, cfg, paths, i, x, positions,
                        *per_layer[i])
        if cfg.is_moe:
            x, a = out
            aux = aux + a
        else:
            x = out
    logits = _head(params, cfg, x)
    return (logits, aux) if cfg.is_moe else logits


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Causal-LM loss: mean token cross-entropy (float32), plus the aux
    loss for MoE."""
    out = forward_logits(params, cfg, batch["tokens"], remat)
    logits, aux = out if cfg.is_moe else (out, None)
    loss = cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
    return loss if aux is None else loss + aux


# ---------------------------------------------------------------------------
# Expert parallelism: every layer over all local ranks at once
# ---------------------------------------------------------------------------

def _ffn_ranks(cfg: ModelConfig, lps: list, xs: list, comm, fused):
    """The FFN half of one layer for every rank: with ``comm`` the
    expert-parallel MoE exchanges across its ranks, else each rank runs
    its FFN (dense, or MoE with a single-pool dispatch) alone.  Returns
    the ranks' outputs and their aux losses (``None`` for dense)."""
    if not cfg.is_moe and cfg.d_ff == 0:
        return xs, None
    hs = [rmsnorm(x, lp["norm2"], cfg.norm_eps) for lp, x in zip(lps, xs)]
    auxs = None
    if comm is not None:
        ys, auxs = moe_ffn_ep([lp["moe"] for lp in lps], cfg, hs, comm,
                              use_fused_kernel=fused)
    elif cfg.is_moe:
        ys, auxs = zip(*(moe_ffn(lp["moe"], cfg, h)
                         for lp, h in zip(lps, hs)))
    else:
        ys = [ffn(lp["ffn"], h) for lp, h in zip(lps, hs)]
    return [x + y for x, y in zip(xs, ys)], auxs


def _ep_layer_forward(cfg: ModelConfig, paths, i: int, positions, comm,
                      fused, *args):
    """MoE layer ``i`` for all local ranks: ``args`` is the ranks' inputs,
    then each rank's layer leaves in ``paths`` order.  Returns the ranks'
    outputs, then their aux losses."""
    nr = len(positions)
    xs, leaves = list(args[:nr]), args[nr:]
    n = len(paths)
    lps = [T.unflatten(zip(paths, leaves[i * n:(i + 1) * n]))
           for i in range(nr)]
    for r in range(nr):
        xs[r], _, _ = _mixer_block(cfg, lps[r], xs[r], positions[r], i)
    xs, auxs = _ffn_ranks(cfg, lps, xs, comm, fused)
    return (*xs, *auxs)


def loss_fn_ep(params: list, cfg: ModelConfig, batches: list, comm,
               remat: bool = True, use_fused_kernel: bool | None = None
               ) -> list:
    """Per-rank losses of the expert-parallel MoE model over ``comm``'s
    local ranks (``params``/``batches``: one tree / batch per rank): each
    layer's attention runs per rank, its MoE exchange across them
    (:func:`moe_ffn_ep`), and with ``remat`` each layer is one
    checkpoint around all ranks, so the backward recomputes the layer's
    exchanges too, as the reference's remat does."""
    _check_family(cfg)
    if not cfg.is_moe or cfg.moe_dispatch != "ep":
        raise ValueError(f"{cfg.name}: loss_fn_ep needs moe_dispatch='ep'")
    embedded = [_embed(p, cfg, b["tokens"]) for p, b in zip(params, batches)]
    xs = [x for x, _ in embedded]
    positions = [pos for _, pos in embedded]
    slices = [layer_slices(p) for p in params]
    paths = slices[0][0]
    nr = len(params)
    auxs = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    for i in range(cfg.n_layers):
        leaves = [leaf for _, per_layer in slices for leaf in per_layer[i]]
        out = run_layer(_ep_layer_forward, remat, cfg, paths, i, positions,
                        comm, use_fused_kernel, *xs, *leaves)
        xs = list(out[:nr])
        auxs = [a + b for a, b in zip(auxs, out[nr:])]
    return [cross_entropy_loss(_head(p, cfg, x), b["targets"], b.get("mask"))
            + a for p, x, b, a in zip(params, xs, batches, auxs)]


# ---------------------------------------------------------------------------
# Tensor parallelism: the dense, MoE and hybrid families over the local
# ranks of a D x M mesh
# ---------------------------------------------------------------------------

def check_tp(cfg: ModelConfig) -> None:
    """Refuse a config tensor parallelism does not run: the
    expert-parallel MoE (its own path; every family runs on a model
    axis)."""
    if cfg.is_moe and cfg.moe_dispatch == "ep":
        raise NotImplementedError(
            f"{cfg.name}: moe_dispatch='ep' runs its own expert-parallel "
            f"path, not tensor parallelism or fsdp_auto")


def _leaf_acts(tp: shd.TensorParallel, paths, lls, per_rank,
               lead: int) -> dict:
    """Each leaf's per-rank blocks as a ``sharding.Act`` (``per_rank``:
    every rank's leaves in ``paths`` order; ``lead``: the stacked dims
    the blocks have lost), the blocks split over the data axes gathered
    first (the allgather whose backward is the reduce-scatter: the data
    ranks' gradients summed)."""
    out = []
    for j, (path, ll) in enumerate(zip(paths, lls)):
        xs = [leaves[j] for leaves in per_rank]
        if ll.data is not None:
            xs = list(shd._Gather.apply(tp.data, ll.data - lead, *xs))
        out.append((path, shd.Act(xs, ll.dims, ll.model)))
    return T.unflatten(out)


def _add(x, y):
    if x.layout != y.layout:
        raise ValueError(f"layouts {x.layout!r} and {y.layout!r}")
    return shd.Act([a + b for a, b in zip(x.xs, y.xs)], x.dims, x.layout)


def _stream(tp: shd.TensorParallel):
    """The residual stream's layout: split on seq when
    sequence-parallel."""
    return "t" if tp.axis.recipe.sequence_parallel else None


def _ffn_tp(ax, p: dict, h):
    """SwiGLU over the layouts (the reference's ``ffn``; ``act_btf`` on
    its hidden)."""
    gate = shd.act_btf(shd.project(ax, h, p["w_gate"], "btd,df->btf"), ax)
    up = shd.act_btf(shd.project(ax, h, p["w_up"], "btd,df->btf"), ax)
    hid = shd.Act([F.silu(g) * u for g, u in zip(gate.xs, up.xs)], "btf",
                  gate.layout)
    return shd.project(ax, hid, p["w_down"], "btf,fd->btd")


def _dense_layer_tp(cfg: ModelConfig, tp: shd.TensorParallel, lp: dict, x,
                    positions, i: int = 0, causal: bool = True):
    """Decoder layer ``i`` of every rank on the stream ``x`` (an ``Act``)
    and the layer's leaves ``lp`` (``Act`` s): ``(x, per-rank aux losses
    or None)``; the FFN is the MoE's for that family, and the hybrid
    family mixes Mamba heads into the attention (:func:`_mixer_tp`).
    ``causal=False``: an encoder layer."""
    ax = tp.axis
    h = attn._norm_tp(ax, x, lp["norm1"], cfg.norm_eps)
    x = _add(x, _mixer_tp(cfg, ax, lp, h, positions, i, causal))
    if cfg.is_moe:
        h = attn._norm_tp(ax, x, lp["norm2"], cfg.norm_eps)
        y, auxs = moe_ffn_tp(ax, lp["moe"], cfg, h,
                             tp.data if tp.pooled else None)
        return _add(x, shd.act_btd(y, ax)), auxs
    if cfg.d_ff > 0:
        h = attn._norm_tp(ax, x, lp["norm2"], cfg.norm_eps)
        x = _add(x, shd.act_btd(_ffn_tp(ax, lp["ffn"], h), ax))
    return x, None


def _mixer_tp(cfg: ModelConfig, ax, lp: dict, h, positions, i: int = 0,
              causal: bool = True):
    """Layer ``i``'s self attention of the normed stream ``h``, laid out
    as ``act_btd`` says; for the hybrid family the attention and the
    Mamba heads on the same ``h``, each summed over the model axis, then
    mixed 50/50 after their own norms (:func:`_hybrid_mix`)."""
    a, _ = attn.self_attention_tp(ax, lp["attn"], cfg, h, positions,
                                  causal=causal, window=_window(cfg, i))
    a = shd.act_btd(a, ax)
    if cfg.family != "hybrid":
        return a
    m = shd.act_btd(ssm.mamba_forward_tp(
        ax, lp["mamba"], cfg, h, chunk=min(cfg.mlstm_chunk,
                                           positions.shape[1])), ax)
    na = attn._norm_tp(ax, a, lp["norm_attn_out"], cfg.norm_eps)
    nm = attn._norm_tp(ax, m, lp["norm_ssm_out"], cfg.norm_eps)
    return shd.Act([0.5 * (u + v) for u, v in zip(na.xs, nm.xs)], "btd",
                   na.layout)


def _tp_layer_forward(cfg: ModelConfig, tp: shd.TensorParallel, paths,
                      lls, positions, nr: int, i: int, *args):
    """Layer ``i`` for all local ranks: ``args`` is the ranks' streams,
    then each rank's layer leaves in ``paths`` order.  Returns the
    streams, then (MoE) the ranks' aux losses."""
    xs, leaves = args[:nr], args[nr:]
    n = len(paths)
    lp = _leaf_acts(tp, paths, lls,
                    [leaves[r * n:(r + 1) * n] for r in range(nr)], 1)
    x, auxs = _dense_layer_tp(cfg, tp, lp, shd.Act(xs, "btd", _stream(tp)),
                              positions, i)
    return (*x.xs, *(auxs or ()))


def _embed_tp(ax, e, tokens: list, dtype):
    """The embedding lookup by ``embed``'s layout: split on vocab, each
    rank zeroes the tokens outside its rows (partial sums); whole or
    split on d_model, a plain lookup."""
    if e.layout not in (None, "v", "d"):
        e = ax.whole(e)
    if e.layout != "v":
        return shd.Act([F.embedding(t.long(), w).to(dtype)
                        for w, t in zip(e.xs, tokens)], "btd", e.layout)
    out = []
    for w, t, c in zip(e.xs, tokens, ax.comm.ranks):
        n = w.shape[0]
        loc = t.long() - c * n
        ok = (loc >= 0) & (loc < n)
        rows = F.embedding(loc.clamp(0, n - 1), w).to(dtype)
        out.append(torch.where(ok[..., None], rows, torch.zeros(
            (), dtype=dtype, device=rows.device)))
    return shd.Act(out, "btd", shd.PARTIAL)


def _cross_entropy_tp(ax, logits, targets: list, masks: list) -> list:
    """Mean token cross-entropy in float32 (``layers.cross_entropy_loss``)
    of vocab-split logits, never gathered: each rank's max (gathered, the
    largest taken), its shard's sum of exponentials and, on the rank
    that owns the target, the target's logit, the last two summed over
    the model axis in one all-reduce."""
    if logits.layout != "v":
        logits = ax.whole(logits)
        return [cross_entropy_loss(x, t, m)
                for x, t, m in zip(logits.xs, targets, masks)]
    l32 = [x.to(torch.float32) for x in logits.xs]
    with torch.no_grad():
        maxes = ax.comm.all_gather([x.amax(-1)[None] for x in l32])
    maxes = [m.amax(0) for m in maxes]
    parts = []
    for x, t, mx, c in zip(l32, targets, maxes, ax.comm.ranks):
        n = x.shape[-1]
        loc = t.long() - c * n
        ok = (loc >= 0) & (loc < n)
        sumexp = torch.exp(x - mx[..., None]).sum(-1)
        gold = torch.gather(x, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        gold = torch.where(ok, gold, torch.zeros((), dtype=gold.dtype,
                                                 device=gold.device))
        parts.append(torch.stack([sumexp, gold], -1))
    out = []
    for tot, mx, mask in zip(ax.reduce(parts), maxes, masks):
        nll = (torch.log(tot[..., 0]) + mx) - tot[..., 1]
        if mask is None:
            out.append(nll.mean())
            continue
        mask = mask.to(torch.float32)
        out.append((nll * mask).sum() / torch.clamp(mask.sum(), min=1.0))
    return out


def _top_tp(tp: shd.TensorParallel, params: list) -> dict:
    """The top-level leaves (embedding, head, final norm) as ``Act`` s."""
    top_paths = [k for k in ("embed", "lm_head", "final_norm")
                 if k in params[0]]
    return _leaf_acts(tp, [(k,) for k in top_paths],
                      [tp.layout.leaves[k] for k in top_paths],
                      [[p[k] for k in top_paths] for p in params], 0)


def _embed_stream_tp(cfg: ModelConfig, tp: shd.TensorParallel, top: dict,
                     batches: list):
    """The embedded stream (an ``Act`` laid out as ``act_btd`` says) and
    the positions."""
    ax = tp.axis
    x = shd.act_btd(_embed_tp(ax, top["embed"],
                              [b["tokens"] for b in batches],
                              dtype_of(cfg)), ax)
    b, s = batches[0]["tokens"].shape
    return x, torch.arange(s, device=x.xs[0].device).expand(b, s)


def _loss_head_tp(cfg: ModelConfig, tp: shd.TensorParallel, top: dict, x,
                  batches: list) -> list:
    """Final norm, the vocab-split head and the vocab-parallel
    cross-entropy of every rank."""
    ax = tp.axis
    h = attn._norm_tp(ax, x, top["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        e = top["embed"]
        head = shd.Act([w.T for w in e.xs], "dv", e.layout)
    else:
        head = top["lm_head"]
    head = head.map(lambda w: w.to(dtype_of(cfg)))
    logits = shd.act_btv(shd.project(ax, h, head, "btd,dv->btv"), ax)
    return _cross_entropy_tp(ax, logits, [b_["targets"] for b_ in batches],
                             [b_.get("mask") for b_ in batches])


def loss_fn_tp(params: list, cfg: ModelConfig, batches: list,
               tp: shd.TensorParallel, remat: bool = True) -> list:
    """Per-rank losses of the dense or MoE model over the local ranks of
    a tensor-parallel mesh (``params``: each rank's tree of blocks,
    ``batches``: each rank's, the model ranks of one data rank sharing
    theirs), plus the summed aux losses for MoE as :func:`loss_fn` adds
    them.  With ``remat`` each layer is one checkpoint around all ranks,
    so its model-axis calls (and fsdp gathers) run again in the
    backward, as the reference's remat repeats its collectives.  Every
    rank's loss is the same bits across its model ranks; each rank takes
    the backward of its own (``sharding.py``)."""
    check_tp(cfg)
    _check_family(cfg)
    nr = len(params)
    top = _top_tp(tp, params)
    x, positions = _embed_stream_tp(cfg, tp, top, batches)
    slices = [layer_slices(p) for p in params]
    paths = slices[0][0]
    lls = [T.get(tp.layout.leaves["layers"], path) for path in paths]
    auxs = [torch.zeros((), dtype=torch.float32, device=x.xs[0].device)
            for _ in range(nr)]
    for i in range(cfg.n_layers):
        leaves = [leaf for _, per_layer in slices for leaf in per_layer[i]]
        out = run_layer(_tp_layer_forward, remat, cfg, tp, paths, lls,
                        positions, nr, i, *x.xs, *leaves)
        x = shd.Act(out[:nr], "btd", x.layout)
        if cfg.is_moe:
            auxs = [a + b for a, b in zip(auxs, out[nr:])]
    losses = _loss_head_tp(cfg, tp, top, x, batches)
    return [loss + a for loss, a in zip(losses, auxs)] if cfg.is_moe \
        else losses


# ---------------------------------------------------------------------------
# Cache paths: prefill and one-token decode, over one rank or all the
# local ranks of an expert-parallel communicator
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """A zeroed KV cache: ``{"k", "v"}``, each ``(L, batch, max_len, Hkv,
    dh)`` in the parameter dtype (every layer at ``max_len``, the hybrid
    family's windowed ones too, as the reference sizes them), and for
    the hybrid family ``"mamba"``, a ``MambaState`` stacked over
    layers."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {name: torch.zeros(shape, dtype=dtype_of(cfg), device=device)
             for name in ("k", "v")}
    if cfg.family == "hybrid":
        cache["mamba"] = ssm.MambaState(*(
            torch.stack([t] * cfg.n_layers) for t in ssm.mamba_init_state(
                cfg, batch, dtype_of(cfg), device)))
    return cache


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Bytes of KV cache one token takes, k and v over every layer."""
    return (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
            * torch.empty((), dtype=dtype_of(cfg)).element_size())


def _write_mamba(cache: dict, i: int, state) -> None:
    """Layer ``i``'s Mamba state into the stacked cache, in place."""
    for dst, src in zip(cache["mamba"], state):
        dst[i].copy_(src)


def _rank_layers(params: list) -> list:
    """Per rank, its per-layer parameter trees (views of the stacked
    leaves)."""
    out = []
    for p in params:
        paths, per_layer = layer_slices(p)
        out.append([T.unflatten(zip(paths, leaves)) for leaves in per_layer])
    return out


@torch.no_grad()
def _prefill_ranks(params: list, cfg: ModelConfig, tokens: list,
                   max_len: int, comm=None, fused=None):
    b, s = tokens[0].shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds cache {max_len}")
    embedded = [_embed(p, cfg, t) for p, t in zip(params, tokens)]
    xs = [x for x, _ in embedded]
    caches = [init_cache(cfg, b, max_len, x.device) for x in xs]
    layers = _rank_layers(params)
    for i in range(cfg.n_layers):
        lps = [per_rank[i] for per_rank in layers]
        for r, (_, positions) in enumerate(embedded):
            xs[r], (k, v), mstate = _mixer_block(cfg, lps[r], xs[r],
                                                 positions, i)
            caches[r]["k"][i, :, :s] = k
            caches[r]["v"][i, :, :s] = v
            if mstate is not None:
                _write_mamba(caches[r], i, mstate)
        xs, _ = _ffn_ranks(cfg, lps, xs, comm, fused)
    # The last token's logits only: (B, S, V) would be 5 GB of bf16 at
    # batch 8 x 2048 x 151936.
    return caches, [_head(p, cfg, x[:, -1]) for p, x in zip(params, xs)]


@torch.no_grad()
def _decode_ranks(params: list, cfg: ModelConfig, caches: list,
                  tokens: list, pos, comm=None, fused=None):
    dev = params[0]["embed"].device
    xs = [F.embedding(torch.as_tensor(t, device=dev).long(),
                      p["embed"])[:, None].to(dtype_of(cfg))
          for p, t in zip(params, tokens)]
    pos = torch.as_tensor(pos, device=dev).long()
    layers = _rank_layers(params)
    for i in range(cfg.n_layers):
        lps = [per_rank[i] for per_rank in layers]
        for r, c in enumerate(caches):
            h = rmsnorm(xs[r], lps[r]["norm1"], cfg.norm_eps)
            a, _ = attn.decode_self_attention(
                lps[r]["attn"], cfg, h, attn.KVCache(c["k"][i], c["v"][i]),
                pos, _window(cfg, i))
            if cfg.family == "hybrid":
                m, mstate = ssm.mamba_decode_step(
                    lps[r]["mamba"], cfg, h,
                    ssm.MambaState(*(t[i] for t in c["mamba"])))
                _write_mamba(c, i, mstate)
                a = _hybrid_mix(cfg, lps[r], a, m)
            xs[r] = xs[r] + a
        xs, _ = _ffn_ranks(cfg, lps, xs, comm, fused)
    return caches, [_head(p, cfg, x[:, 0]) for p, x in zip(params, xs)]


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int):
    """Run the ``(B, S)`` prompt: ``(cache, logits)``, the cache
    :func:`init_cache`'s with the prompt's k/v in rows ``[0, S)`` and the
    logits ``(B, V)`` of the last token."""
    _check_family(cfg)
    caches, logits = _prefill_ranks([params], cfg, [tokens], max_len)
    return caches[0], logits[0]


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token, pos):
    """One token per row: ``token`` (B,), ``pos`` a scalar (the whole batch
    at one offset) or ``(B,)`` (per-row offsets, continuous batching).
    Writes the token's k/v (and Mamba state) into ``cache`` in place;
    returns ``(cache, logits (B, V))``."""
    _check_family(cfg)
    caches, logits = _decode_ranks([params], cfg, [cache], [token], pos)
    return caches[0], logits[0]


def _check_ep(cfg: ModelConfig) -> None:
    _check_family(cfg)
    if not cfg.is_moe or cfg.moe_dispatch != "ep":
        raise ValueError(f"{cfg.name}: the ep cache paths need "
                         f"moe_dispatch='ep'")


def prefill_ep(params: list, cfg: ModelConfig, tokens: list, max_len: int,
               comm, use_fused_kernel: bool | None = None):
    """:func:`prefill` for every local rank of ``comm`` (``params`` /
    ``tokens``: one per rank; serving never writes parameters, so the
    ranks may share one tree): attention per rank, each layer's MoE
    exchange across them (:func:`moe_ffn_ep`).  Returns per-rank
    ``(caches, logits)``."""
    _check_ep(cfg)
    return _prefill_ranks(params, cfg, tokens, max_len, comm,
                          use_fused_kernel)


def decode_step_ep(params: list, cfg: ModelConfig, caches: list,
                   tokens: list, pos, comm,
                   use_fused_kernel: bool | None = None):
    """:func:`decode_step` for every local rank of ``comm``, as
    :func:`prefill_ep`; ``pos`` is shared.  Returns per-rank ``(caches,
    logits)``."""
    _check_ep(cfg)
    return _decode_ranks(params, cfg, caches, tokens, pos, comm,
                         use_fused_kernel)
