"""State-space and recurrent sequence mixers, ported from
``repro/models/ssm.py`` (plain tensor ops there too: no Pallas kernel,
so no kernel is owed).

* ``mamba``: the selective diagonal SSM of hymba's SSM heads, scanned
  chunk by chunk: inside a chunk a log-depth (Hillis-Steele) scan with
  the reference's combine ``(a1·a2, a2·b1 + b2)`` in place of
  ``jax.lax.associative_scan``, across chunks a carried state, so the
  Python loop runs once per chunk, not once per token.
* ``mlstm``: xLSTM's matrix-memory LSTM in chunkwise-parallel form
  (intra-chunk masked quadratic, inter-chunk recurrent ``(C, n)``
  state).
* ``slstm``: xLSTM's scalar-memory LSTM with exponential gating and the
  m-stabilizer, a true recurrence: a Python loop over the sequence (the
  reference's ``lax.scan``), one step per token.

Each mixer has a ``*_shapes`` (the reference's ``init_*`` leaves), a
full-sequence ``*_forward`` that takes and returns its state, an O(1)
``*_decode_step``, an ``*_init_state`` and a tensor-parallel
``*_forward_tp`` over the local ranks of a mesh (``models/sharding.py``:
each rank its own inner channels or heads, the projections that
contract them partial sums; training only, from zero states).  The
states are the reference's NamedTuples with tensors in them.  The
arithmetic follows the reference's expressions and order; the scan's
association differs from XLA's, so results agree within a tolerance,
not bitwise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import sharding as shd


def _pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk (assigned shapes are powers of
    two so this stays at the configured chunk; odd smoke lengths degrade
    gracefully)."""
    ch = max(1, min(chunk, s))
    while s % ch:
        ch -= 1
    return ch


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (hymba SSM heads)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    h: torch.Tensor      # (B, d_inner, state) float32
    conv: torch.Tensor   # (B, conv_k - 1, d_inner) rolling conv window


def mamba_shapes(cfg) -> dict:
    """Shapes of one Mamba block's leaves (the reference's
    ``init_mamba``)."""
    d = cfg.d_model
    d_in, n = cfg.ssm_expand * d, cfg.ssm_state
    return {"w_in": (d, 2 * d_in), "conv_w": (cfg.ssm_conv, d_in),
            "w_dt": (d_in, 1), "dt_bias": (d_in,), "w_B": (d_in, n),
            "w_C": (d_in, n), "A_log": (d_in, n), "D": (d_in,),
            "w_out": (d_in, d)}


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along seq.  x (B,S,din), w (K,din).
    state: (B,K-1,din) previous tail or None (zeros)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return out, new_state


def _ssm_scan_chunk(a, b, h0):
    """Linear recurrence h_t = a_t * h_{t-1} + b_t within one chunk.
    a, b: (B, L, d_in, n); h0: (B, d_in, n).  A log-depth inclusive scan
    (Hillis-Steele: at offset 1, 2, 4, ... every element folds in the one
    that far before it) with the reference's combine ``(a1·a2, a2·b1 +
    b2)``, element ``t - d`` the earlier operand."""
    L = a.shape[1]
    d = 1
    while d < L:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    h = a * h0[:, None] + b
    return h, h[:, -1]


def mamba_forward(p, cfg, x, *, chunk: int = 256,
                  state: MambaState | None = None):
    """x: (B, S, d) -> (y (B, S, d), final MambaState).  The scan runs
    over chunks of :func:`_pick_chunk` (S, chunk) steps."""
    xz = x @ p["w_in"]
    xs, z = torch.chunk(xz, 2, dim=-1)
    conv_state = state.conv if state is not None else None
    xs, conv_tail = _causal_conv(xs, p["conv_w"], conv_state)
    xs = F.silu(xs)
    y, h = _mamba_scan(cfg, xs, z, xs @ p["w_dt"], xs @ p["w_B"],
                       xs @ p["w_C"], p, chunk,
                       state.h if state is not None else None)
    return y @ p["w_out"], MambaState(h=h, conv=conv_tail)


def _mamba_scan(cfg, xs, z, dt_in, Bm, Cm, p, chunk: int, h=None):
    """The selective scan of the channels of ``xs`` (B, S, d_in'), gated
    by ``z``: ``dt_in`` (B, S, 1) is ``xs @ w_dt``, ``Bm`` / ``Cm`` (B,
    S, n) the state projections, ``p`` holds these channels' ``dt_bias``,
    ``A_log`` and ``D``.  Returns ``(y (B, S, d_in'), final h)``."""
    b, s, d_in = xs.shape
    n = cfg.ssm_state
    f32 = torch.float32
    dt = F.softplus(dt_in + p["dt_bias"])                      # (B,S,d_in)
    A = -torch.exp(p["A_log"].to(f32))                         # (d_in, n)
    a = torch.exp(dt.to(f32)[..., None] * A)                   # (B,S,d_in,n)
    bterm = (dt * xs).to(f32)[..., None] * Bm[:, :, None, :].to(f32)
    if h is None:
        h = torch.zeros((b, d_in, n), dtype=f32, device=xs.device)
    ch = _pick_chunk(s, chunk)
    hs = []
    for a_c, b_c in zip(a.split(ch, dim=1), bterm.split(ch, dim=1)):
        h_all, h = _ssm_scan_chunk(a_c, b_c, h)
        hs.append(h_all)
    h_seq = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    y = torch.einsum("bsdn,bsn->bsd", h_seq, Cm.to(f32))
    y = (y + p["D"].to(f32) * xs.to(f32)).to(xs.dtype)
    return y * F.silu(z), h


def _summed(tp, acts: list, local: bool) -> list:
    """Each ``Act``'s per-rank tensors, whole: with ``local`` as they
    enter rank-local computations (``ModelAxis.entering``; partial sums
    of the same leading dims summed in one all-reduce of their
    concatenation, its backward one all-reduce of the cotangents), else
    for computations every rank repeats (``ModelAxis.whole``)."""
    if not local:
        return [tp.whole(a).xs for a in acts]
    if len(acts) > 1 and all(a.layout == shd.PARTIAL for a in acts):
        cat = shd.Act([torch.cat(xs, -1) for xs in zip(*(a.xs for a in acts))],
                      acts[0].dims, shd.PARTIAL)
        sizes = [a.xs[0].shape[-1] for a in acts]
        parts = [x.split(sizes, -1) for x in tp.entering(cat)]
        return [[p[j] for p in parts] for j in range(len(acts))]
    return [tp.entering(a) for a in acts]


def mamba_forward_tp(tp, p: dict, cfg, x, *, chunk: int = 256):
    """:func:`mamba_forward` of every local rank of a tensor-parallel mesh
    (``models/sharding.py``): ``p`` maps each leaf name to its per-rank
    blocks (``Act`` s), ``x`` is the normed stream.  ``w_in``'s blocks are
    runs of the concatenated ``[x | z]`` columns; :func:`sharding.pieces`
    brings every rank its own channels of both halves, the channels
    ``conv_w``, ``A_log``, ``D`` and ``dt_bias`` are split on.  The
    projections contracting the split channels (``w_dt``, ``w_B``,
    ``w_C``) are partial sums, summed in one all-reduce as they enter the
    scan, which runs on each rank's channels; ``w_out``'s output is the
    partial sums the caller's ``act_btd`` sums."""
    xz = shd.project(tp, x, p["w_in"], "btd,dx->btx")
    xs, z = shd.pieces(tp, xz, "x", 2, "i")
    lay = "i" if "i" in (xs.layout, p["conv_w"].layout) else None
    xs, z = tp.to(xs, lay), tp.to(z, lay)
    conv = tp.like(p["conv_w"], xs)
    xs = shd.Act([F.silu(_causal_conv(a, w)[0]) for a, w in zip(xs.xs, conv)],
                 "bti", lay)
    dt_in, Bm, Cm = _summed(tp, [
        shd.project(tp, xs, p[k], eq) for k, eq in (
            ("w_dt", "bti,ir->btr"), ("w_B", "bti,in->btn"),
            ("w_C", "bti,in->btn"))], lay is not None)
    leaves = [{k: w for k, w in zip(("dt_bias", "A_log", "D"), ws)}
              for ws in zip(*(tp.like(p[k], xs)
                              for k in ("dt_bias", "A_log", "D")))]
    ys = [_mamba_scan(cfg, a, g, dt, bm, cm, lv, chunk)[0] for
          a, g, dt, bm, cm, lv in zip(xs.xs, z.xs, dt_in, Bm, Cm, leaves)]
    return shd.project(tp, shd.Act(ys, "bti", lay), p["w_out"],
                       "bti,id->btd")


def mamba_decode_step(p, cfg, x, state: MambaState):
    """x: (B, 1, d) one token; O(1) state update."""
    return mamba_forward(p, cfg, x, chunk=1, state=state)


def mamba_init_state(cfg, batch, dtype=torch.float32, device=None
                     ) -> MambaState:
    d_in = cfg.ssm_expand * cfg.d_model
    return MambaState(
        h=torch.zeros((batch, d_in, cfg.ssm_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                         device=device))


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory), chunkwise parallel
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, H, dk, dv)
    n: torch.Tensor    # (B, H, dk)


def mlstm_shapes(cfg) -> dict:
    """Shapes of one mLSTM block's leaves (the reference's
    ``init_mlstm``)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": (d, h, dh), "wk": (d, h, dh), "wv": (d, h, dh),
            "wi": (d, h), "wf": (d, h), "wo_gate": (d, h, dh),
            "wo": (h, dh, d), "f_bias": (h,), "i_bias": (h,)}


def _mlstm_chunk(q, k, v, lf, li, C0, n0):
    """One chunk.  q,k,v: (B,L,H,dh); lf,li: (B,L,H) log gates (<= 0).
    C0: (B,H,dk,dv); n0: (B,H,dk).  Returns h (B,L,H,dh), C1, n1."""
    L, dh = q.shape[1], q.shape[3]
    f32 = torch.float32
    q, k, v = (t.to(f32) for t in (q, k, v))
    q = q * (dh ** -0.5)  # scale ONCE so intra (q·k) and inter (q·C, q·n)
    #                       paths stay consistent across chunk boundaries
    lf, li = lf.to(f32), li.to(f32)
    cf = torch.cumsum(lf, dim=1)                   # inclusive prefix
    # Inter-chunk: decay from chunk start to t.
    decay_t = torch.exp(cf)                        # (B,L,H)
    h_inter = torch.einsum("blhk,bhkv->blhv", q, C0) * decay_t[..., None]
    d_inter = torch.einsum("blhk,bhk->blh", q, n0) * decay_t
    # Intra-chunk: w[t,s] = exp(cf_t - cf_s + li_s) for s <= t.
    g = li - cf                                    # (B,L,H)
    logw = cf[:, :, None, :] + g[:, None, :, :]    # (B, t, s, H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    w = torch.where(mask[None, :, :, None], torch.exp(logw),
                    torch.zeros((), dtype=f32, device=q.device))
    scores = torch.einsum("blhk,bshk->blsh", q, k)
    wsc = w * scores
    h_intra = torch.einsum("blsh,bshv->blhv", wsc, v)
    d_intra = wsc.sum(dim=2)
    denom = torch.clamp(torch.abs(d_inter + d_intra), min=1.0)
    h = (h_inter + h_intra) / denom[..., None]
    # State update to end of chunk.
    decay_L = torch.exp(cf[:, -1])                 # (B,H)
    sdecay = torch.exp(cf[:, -1:, :] - cf + li)    # (B,L,H)
    C1 = (C0 * decay_L[..., None, None]
          + torch.einsum("blh,blhk,blhv->bhkv", sdecay, k, v))
    n1 = n0 * decay_L[..., None] + torch.einsum("blh,blhk->bhk", sdecay, k)
    return h, C1, n1


def mlstm_forward(p, cfg, x, *, state: MLSTMState | None = None):
    """x: (B, S, d) -> (out (B, S, d), final MLSTMState), chunk by chunk
    of :func:`_pick_chunk` (S, ``cfg.mlstm_chunk``) steps."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    lf = F.logsigmoid(x @ p["wf"] + p["f_bias"])         # (B,S,H) <= 0
    li = F.logsigmoid(x @ p["wi"] + p["i_bias"])         # sigmoid input gate
    hseq, C, n = _mlstm_seq(cfg, q, k, v, lf, li, state)
    og = torch.sigmoid(torch.einsum("bsd,dhk->bshk", x, p["wo_gate"]))
    out = torch.einsum("bshk,hkd->bsd", (hseq * og).to(x.dtype), p["wo"])
    return out, MLSTMState(C=C, n=n)


def _mlstm_seq(cfg, q, k, v, lf, li, state=None):
    """The chunkwise recurrence over the heads of ``q`` (B, S, H', dh):
    ``(h (B, S, H', dh), C, n)``."""
    b, s, h_, dh = q.shape
    ch = _pick_chunk(s, cfg.mlstm_chunk)
    f32 = torch.float32
    C = (state.C if state is not None
         else torch.zeros((b, h_, dh, dh), dtype=f32, device=q.device))
    n = (state.n if state is not None
         else torch.zeros((b, h_, dh), dtype=f32, device=q.device))
    hs = []
    for qc, kc, vc, lfc, lic in zip(*(t.split(ch, dim=1)
                                      for t in (q, k, v, lf, li))):
        hout, C, n = _mlstm_chunk(qc, kc, vc, lfc, lic, C, n)
        hs.append(hout)
    return (torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]), C, n


def _heads_tp(tp, acts: list) -> tuple:
    """The mixer's per-head inputs on one layout: each rank its own heads
    where the first is split on them, else every head on every rank."""
    lay = "h" if acts[0].layout == "h" else None
    return lay, [tp.to(a, lay) for a in acts]


def _gate_tp(tp, pre, bias, fn):
    """``fn(pre + bias)`` of every rank, ``bias`` (a leaf ``Act``) as
    ``pre``'s layout needs it (a replicated leaf's slice of this rank's
    heads enters through ``ModelAxis.copy``)."""
    return [fn(a + b) for a, b in zip(pre.xs, tp.like(bias, pre))]


def mlstm_forward_tp(tp, p: dict, cfg, x):
    """:func:`mlstm_forward` of every local rank of a tensor-parallel
    mesh (``p``: each leaf's per-rank ``Act``; ``x``: the normed stream).
    Every rank projects and runs the recurrence of its own heads (``wq``,
    ``wk``, ``wv``, ``wi``, ``wf``, ``wo_gate`` split on them; the
    replicated ``f_bias`` / ``i_bias`` sliced); ``wo``'s output is the
    partial sums the caller's ``act_btd`` sums."""
    proj = [shd.project(tp, x, p[k], eq) for k, eq in (
        ("wq", "btd,dhk->bthk"), ("wk", "btd,dhk->bthk"),
        ("wv", "btd,dhk->bthk"), ("wf", "btd,dh->bth"),
        ("wi", "btd,dh->bth"), ("wo_gate", "btd,dhk->bthk"))]
    lay, (q, k, v, f_pre, i_pre, o_pre) = _heads_tp(tp, proj)
    lf = _gate_tp(tp, f_pre, p["f_bias"], F.logsigmoid)
    li = _gate_tp(tp, i_pre, p["i_bias"], F.logsigmoid)
    outs = []
    for r, xr in enumerate(x.xs):
        hseq = _mlstm_seq(cfg, q.xs[r], k.xs[r], v.xs[r], lf[r], li[r])[0]
        og = torch.sigmoid(o_pre.xs[r])
        outs.append((hseq * og).to(xr.dtype))
    return shd.project(tp, shd.Act(outs, "bthk", lay), p["wo"],
                       "bthk,hkd->btd")


def mlstm_decode_step(p, cfg, x, state: MLSTMState):
    return mlstm_forward(p, cfg, x, state=state)


def mlstm_init_state(cfg, batch, device=None) -> MLSTMState:
    f32 = torch.float32
    return MLSTMState(
        C=torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                      dtype=f32, device=device),
        n=torch.zeros((batch, cfg.n_heads, cfg.head_dim), dtype=f32,
                      device=device))


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory, exp gating + stabilizer, true recurrence)
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, dh)
    n: torch.Tensor   # (B, H, dh)
    m: torch.Tensor   # (B, H, dh) stabilizer
    h: torch.Tensor   # (B, H, dh) recurrent output


def slstm_shapes(cfg) -> dict:
    """Shapes of one sLSTM block's leaves (the reference's
    ``init_slstm``)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"w_x": (d, 4, h, dh), "r_h": (4, h, dh, dh), "bias": (4, h, dh),
            "wo": (h, dh, d), "f_bias_extra": (h, dh)}


def slstm_step(r_h, bias, f_extra, x_proj_t, state: SLSTMState
               ) -> SLSTMState:
    """One step, heads first: ``x_proj_t`` (H, B, 4, dh) is the input
    contribution at t, ``state``'s tensors are (H, B, dh), ``r_h`` is
    ``(H, dh, 4·dh)`` (the reference's ``(4, H, dh, dh)`` per head, the
    four gates side by side), ``bias`` (H, 1, 4, dh) and ``f_extra`` (H, 1,
    dh); all float32.  The reference's expressions in its order; only the
    layout differs, so that the recurrent product is one batched matmul
    over heads and no step permutes."""
    h_, b = state.h.shape[:2]
    rec = torch.matmul(state.h, r_h).view(h_, b, 4, -1)
    pre = x_proj_t + rec + bias
    z = torch.tanh(pre[:, :, 0])
    li = pre[:, :, 1]                                 # log-space exp gate
    lf = pre[:, :, 2] + f_extra
    o = torch.sigmoid(pre[:, :, 3])
    lfm = lf + state.m                                # once: the reference
    m_new = torch.maximum(lfm, li)                    # forms it twice
    i_s = torch.exp(li - m_new)
    f_s = torch.exp(lfm - m_new)
    c_new = f_s * state.c + i_s * z
    n_new = f_s * state.n + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return SLSTMState(c=c_new, n=n_new, m=m_new, h=h_new)


def slstm_forward(p, cfg, x, *, state: SLSTMState | None = None):
    """x: (B, S, d) -> (out (B, S, d), final SLSTMState): one
    :func:`slstm_step` per token, in its heads-first layout (converted
    once on the way in and out; ``unbind`` gives each step its input so
    the backward stacks the steps' gradients once)."""
    b = x.shape[0]
    x_proj = torch.einsum("bsd,dghk->bsghk", x, p["w_x"])  # (B,S,4,H,dh)
    st = (state if state is not None
          else slstm_init_state(cfg, b, device=x.device))
    hseq, st = _slstm_seq(*_slstm_heads_first(p), x_proj,
                          SLSTMState(*(t.transpose(0, 1) for t in st)))
    out = torch.einsum("bshk,hkd->bsd", hseq.to(x.dtype), p["wo"])
    return out, SLSTMState(*(t.transpose(0, 1) for t in st))


def _slstm_heads_first(p) -> tuple:
    """``r_h``, ``bias`` and ``f_bias_extra`` of ``p`` (any number of
    heads) in :func:`slstm_step`'s layout, float32."""
    f32 = torch.float32
    g, h_, dh = p["r_h"].shape[:3]
    r_h = p["r_h"].to(f32).permute(1, 2, 0, 3).reshape(h_, dh, g * dh)
    bias = p["bias"].to(f32).permute(1, 0, 2)[:, None]      # (H, 1, 4, dh)
    return r_h, bias, p["f_bias_extra"].to(f32)[:, None]    # (H, 1, dh)


def _slstm_seq(r_h, bias, f_extra, x_proj, st: SLSTMState):
    """The recurrence over ``x_proj`` (B, S, 4, H, dh) from the heads-first
    state ``st``: ``(h (B, S, H, dh) float32, final state)``."""
    hs = []
    for x_t in x_proj.to(torch.float32).permute(1, 3, 0, 2, 4).unbind(0):
        st = slstm_step(r_h, bias, f_extra, x_t, st)
        hs.append(st.h)
    return torch.stack(hs, dim=2).permute(1, 2, 0, 3), st   # (B,S,H,dh)


def slstm_forward_tp(tp, p: dict, cfg, x):
    """:func:`slstm_forward` of every local rank of a tensor-parallel
    mesh: each rank the recurrence of its own heads (``w_x`` and ``r_h``
    split on them, the replicated ``bias`` / ``f_bias_extra`` sliced),
    the local ranks' heads side by side in ONE step loop (the step is
    per head, so the loop's host time is one rank's).  ``wo``'s output is
    the partial sums the caller's ``act_btd`` sums."""
    proj = shd.project(tp, x, p["w_x"], "btd,dghk->btghk")
    lay, (proj,) = _heads_tp(tp, [proj])
    leaves = [tp.like(p[k], proj) for k in ("r_h", "bias", "f_bias_extra")]
    firsts = [_slstm_heads_first(dict(zip(("r_h", "bias", "f_bias_extra"),
                                          ws))) for ws in zip(*leaves)]
    nh = [r_h.shape[0] for r_h, _, _ in firsts]
    b = x.xs[0].shape[0]
    dh = cfg.head_dim
    z = torch.zeros((sum(nh), b, dh), dtype=torch.float32,
                    device=x.xs[0].device)
    st = SLSTMState(c=z, n=z, m=torch.full_like(z, -1e30), h=z)
    hseq, _ = _slstm_seq(*(torch.cat(t) for t in zip(*firsts)),
                         torch.cat(proj.xs, 3), st)
    outs = [h.to(xr.dtype) for h, xr in zip(hseq.split(nh, 2), x.xs)]
    return shd.project(tp, shd.Act(outs, "bthk", lay), p["wo"],
                       "bthk,hkd->btd")


def slstm_decode_step(p, cfg, x, state: SLSTMState):
    return slstm_forward(p, cfg, x, state=state)


def slstm_init_state(cfg, batch, device=None) -> SLSTMState:
    shp = (batch, cfg.n_heads, cfg.head_dim)
    z = torch.zeros(shp, dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, m=torch.full(shp, -1e30, dtype=torch.float32,
                                             device=device), h=z)
