"""Analytic FLOP / HBM-byte accounting per (arch × shape × mesh), ported
from ``repro/roofline/analytic.py``.

The terms are closed forms of the config and the cell, so they need no
trace and no card: every function here is the reference's, expression
for expression and in the same order, so each result is the same Python
float (the CPU tests hold them with ``==``).  The only change is that
the VLM's group size comes from the port's ``models/vlm.py``.

Conventions (the reference's): flops count multiply-accumulates as 2
ops; attention is charged as full S_q×S_k rectangles (the causal tiles
a flash loop could skip are charged too); backward = 2× forward; full
remat adds ~1× forward for the rematerialized region.  All outputs are
PER CHIP (global / n_chips), assuming the work spreads evenly.

The port's own use (``roofline/analysis.py``): ``n_chips`` is the
number of ranks, which on one card are virtual ranks that the card runs
one after another, so the card's terms are ``n_chips`` times these.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CellSpec:
    kind: str          # train | prefill | decode
    seq: int           # context length
    batch: int         # global batch
    n_chips: int
    tp: int            # model-axis size
    dp_world: int      # product of data axes
    remat: bool = True


def _attn_proj_flops(cfg) -> float:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return 2 * d * h * dh + 2 * 2 * d * hkv * dh + 2 * h * dh * d


def _attn_score_flops(cfg, s_ctx: float) -> float:
    """Per token: QK^T + PV against s_ctx keys."""
    return 4 * s_ctx * cfg.n_heads * cfg.head_dim


def _ffn_flops(cfg) -> float:
    return 3 * 2 * cfg.d_model * cfg.d_ff


def _moe_flops(cfg) -> float:
    # capacity-padded dispatch: cf * K experts' worth of SwiGLU + router
    return (cfg.capacity_factor * cfg.experts_per_token * _ffn_flops(cfg)
            + 2 * cfg.d_model * cfg.n_experts)


def _mamba_flops(cfg) -> float:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    return (2 * d * 2 * d_in            # in_proj
            + 2 * cfg.ssm_conv * d_in   # depthwise conv
            + 2 * d_in * (1 + 2 * n)    # dt, B, C projections
            + 10 * d_in * n             # scan element ops
            + 2 * d_in * n              # y = h·C
            + 2 * d_in * d)             # out_proj


def _mlstm_flops(cfg) -> float:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    ch = cfg.mlstm_chunk
    return (4 * 2 * d * h * dh          # q,k,v,ogate projections
            + 2 * 2 * d * h             # i,f gates
            + 4 * ch * h * dh           # intra-chunk scores+accum (per tok)
            + 6 * dh * dh * h           # state read + update
            + 2 * h * dh * d)           # out proj


def _slstm_flops(cfg) -> float:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return (2 * d * 4 * h * dh          # input projections
            + 4 * 2 * dh * dh * h       # recurrent R matmuls
            + 30 * h * dh               # gates/elementwise
            + 2 * h * dh * d)           # out proj


def _layer_flops_per_token(cfg, s_ctx: float) -> float:
    """One decoder-layer forward, per token, context length s_ctx."""
    fam = cfg.family
    if fam == "ssm_xlstm":
        # alternating mLSTM / sLSTM
        return (_mlstm_flops(cfg) + _slstm_flops(cfg)) / 2
    f = _attn_proj_flops(cfg) + _attn_score_flops(cfg, s_ctx)
    if fam == "hybrid":
        f += _mamba_flops(cfg)
    if cfg.is_moe:
        f += _moe_flops(cfg)
    elif cfg.d_ff:
        f += _ffn_flops(cfg)
    return f


def _cross_layer_flops_per_token(cfg, n_mem: int) -> float:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return (2 * d * h * dh + 2 * h * dh * d       # q, o proj
            + _attn_score_flops(cfg, n_mem)
            + _ffn_flops(cfg))


def _mem_kv_proj_flops(cfg, n_mem: int) -> float:
    """Projecting memory K/V for ONE cross-attn layer."""
    return n_mem * 2 * 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim


def forward_flops_global(cfg, seq: int, batch: int, kind: str) -> float:
    """Whole-model forward FLOPs for the cell (global, all chips)."""
    fam = cfg.family
    tokens = batch * seq

    if kind == "decode":
        # one new token against a cache of length `seq`
        tok = batch
        if fam == "ssm_xlstm":
            per_layer = (_mlstm_flops(cfg) + _slstm_flops(cfg)) / 2
            core = cfg.n_layers * per_layer * tok
        elif fam == "hybrid":
            per_layer = []
            for i in range(cfg.n_layers):
                ctx = seq if i in cfg.global_attn_layers else min(
                    cfg.sliding_window, seq)
                per_layer.append(_attn_proj_flops(cfg)
                                 + _attn_score_flops(cfg, ctx)
                                 + _mamba_flops(cfg) + _ffn_flops(cfg))
            core = sum(per_layer) * tok
        elif fam == "encdec":
            dec = cfg.n_layers * (_attn_proj_flops(cfg)
                                  + _attn_score_flops(cfg, cfg.dec_len)
                                  + _cross_layer_flops_per_token(cfg, seq))
            core = dec * tok
        elif fam == "vlm":
            from ..models.vlm import SELF_PER_GROUP
            ng = cfg.n_layers // (SELF_PER_GROUP + 1)
            core = (ng * SELF_PER_GROUP * (_attn_proj_flops(cfg)
                                           + _attn_score_flops(cfg, seq))
                    + ng * _cross_layer_flops_per_token(cfg,
                                                        cfg.n_image_tokens)
                    + ng * SELF_PER_GROUP * _ffn_flops(cfg)) * tok
        else:
            ctx = min(cfg.sliding_window, seq) if cfg.sliding_window else seq
            core = cfg.n_layers * _layer_flops_per_token(cfg, ctx) * tok
        head = 2 * cfg.d_model * cfg.vocab_size * tok
        return core + head

    # full-sequence passes (train / prefill).  Our flash loop computes all
    # S^2 tiles -> charge full rectangles (baseline honesty).
    s_ctx = seq
    if fam == "encdec":
        enc = cfg.enc_layers * (_attn_proj_flops(cfg)
                                + _attn_score_flops(cfg, seq)
                                + _ffn_flops(cfg)) * batch * seq
        dec_tok = batch * min(cfg.dec_len, seq)
        dec = cfg.n_layers * (_attn_proj_flops(cfg)
                              + _attn_score_flops(cfg, min(cfg.dec_len, seq))
                              + _cross_layer_flops_per_token(cfg, seq)
                              - _ffn_flops(cfg) + 2 * _ffn_flops(cfg)) * dec_tok
        memproj = cfg.n_layers * _mem_kv_proj_flops(cfg, seq) * batch
        head_tok = dec_tok
        core = enc + dec + memproj
    elif fam == "vlm":
        from ..models.vlm import SELF_PER_GROUP
        ng = cfg.n_layers // (SELF_PER_GROUP + 1)
        core = (ng * SELF_PER_GROUP * (_attn_proj_flops(cfg)
                                       + _attn_score_flops(cfg, s_ctx)
                                       + _ffn_flops(cfg))
                + ng * _cross_layer_flops_per_token(cfg, cfg.n_image_tokens)
                ) * tokens
        core += ng * _mem_kv_proj_flops(cfg, cfg.n_image_tokens) * batch
        head_tok = tokens
    elif fam == "hybrid":
        per = 0.0
        for i in range(cfg.n_layers):
            ctx = s_ctx if i in cfg.global_attn_layers else min(
                cfg.sliding_window, s_ctx)
            per += (_attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx)
                    + _mamba_flops(cfg) + _ffn_flops(cfg))
        core = per * tokens
        head_tok = tokens
    elif fam == "ssm_xlstm":
        core = cfg.n_layers * ((_mlstm_flops(cfg) + _slstm_flops(cfg)) / 2
                               ) * tokens
        head_tok = tokens
    else:
        core = cfg.n_layers * _layer_flops_per_token(cfg, s_ctx) * tokens
        head_tok = tokens
    head = 2 * cfg.d_model * cfg.vocab_size * head_tok
    return core + head


def cell_flops_per_chip(cfg, cell: CellSpec) -> float:
    fwd = forward_flops_global(cfg, cell.seq, cell.batch, cell.kind)
    if cell.kind == "train":
        mult = 3.0  # fwd + bwd(2x)
        if cell.remat:
            mult += 1.0  # recompute fwd
        total = fwd * mult
        # optimizer elementwise (~24 flops/param over the DP world)
        total += 24.0 * cfg.param_count()
    else:
        total = fwd
    return total / cell.n_chips


# ---------------------------------------------------------------------------
# HBM bytes
# ---------------------------------------------------------------------------

def _param_bytes(cfg) -> float:
    return 2.0 * cfg.param_count()  # bf16


def cell_hbm_bytes_per_chip(cfg, cell: CellSpec) -> float:
    d, v = cfg.d_model, cfg.vocab_size
    L = cfg.n_layers + cfg.enc_layers
    n_chips = cell.n_chips
    pb_chip = _param_bytes(cfg) / cell.tp  # params replicated over data
    if cell.kind == "train":
        b_loc_tokens = cell.batch * cell.seq / cell.dp_world
        # params: read fwd + remat-fwd + bwd; grads write+read (bf16);
        passes = 3 if cell.remat else 2
        t = pb_chip * (passes + 2)
        # optimizer: m,v read+write fp32 on 1/world shards + param shard rw
        n_shard = cfg.param_count() / cell.dp_world / cell.tp
        t += n_shard * (4 * 4 + 2 * 2 + 2 * 2)
        # residual stream activations saved at layer boundaries (remat):
        t += L * b_loc_tokens * d * 2 * 2  # write + re-read, bf16
        # per-layer working tensors ~ 6 streams of (tok, d) x passes
        t += passes * L * b_loc_tokens * d * 2 * 6
        # logits fwd+bwd (vocab sharded over tp)
        t += 3 * cell.batch * cell.seq / cell.dp_world * v / cell.tp * 2
        return t
    if cell.kind == "prefill":
        tok_chip = cell.batch * cell.seq / cell.dp_world
        t = pb_chip
        t += L * tok_chip * d * 2 * 4          # activations through layers
        # KV cache write
        t += (cfg.n_layers * cell.batch * cell.seq * cfg.n_kv_heads
              * cfg.head_dim * 2 * 2) / n_chips
        return t
    # decode: params + full KV cache read per token step
    t = pb_chip
    if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
        kv_len = cell.seq
        t += (cfg.n_layers * cell.batch * kv_len * cfg.n_kv_heads
              * cfg.head_dim * 2 * 2) / n_chips
    if cfg.family == "moe":
        # only active experts' weights needed per decode microbatch — but
        # weights are resident; count resident read of active fraction
        act = cfg.active_param_count() / cfg.param_count()
        t = _param_bytes(cfg) * act / cell.tp + (t - pb_chip)
    return t


def analytic_cell(cfg, cell: CellSpec) -> dict:
    return {
        "flops_per_chip": cell_flops_per_chip(cfg, cell),
        "hbm_bytes_per_chip": cell_hbm_bytes_per_chip(cfg, cell),
    }
