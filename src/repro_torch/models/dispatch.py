"""MoE dispatch stages — router → dispatch → expert FFN → combine.

Ported from ``repro/models/dispatch.py``.  One set of composable stages
behind the ``cfg.moe_dispatch`` modes the port runs:

  global    one flat token pool (the stages applied directly);
  rowwise   per-sequence pools: capacity ``capacity(cfg, S)`` per
            sequence and per-sequence dropping.  The stages carry the
            batch dimension (the reference runs them under ``vmap``):
            expert e of sequence b is pool expert ``b·E + e`` of one
            flat dispatch, so one stable sort, one prefix sum and one
            scatter serve every sequence, and the expert FFN runs on a
            ``(B, E, C, d)`` buffer;
  ep        expert parallelism over the ranks of a communicator (the
            reference's manual mesh axis ``cfg.ep_axis``): each rank's
            ``(E, C, d)`` dispatch buffer goes to the expert owners with
            the circulant alltoall (paper §4, ``ceil(log2 p)`` exchanges)
            and the ragged per-expert routed-token counts with the
            alltoallv, experts run on their owner, and results return by
            the reverse exchange.

Tokens are stably argsorted by expert, positioned within their expert by
a counts/starts prefix sum, dropped beyond capacity ``C = min(ceil(cf·N·K
/ E) rounded up to 8, N·K)``, gathered into an ``(E, C, d)`` buffer, run
through batched expert FFNs (one einsum), and scatter-added back weighted
by their router gates.  ``lax.top_k`` breaks ties toward the lower index
and ``torch.topk`` does not promise to: router probabilities that tie
may route differently (the tests use inputs without ties).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..comm import LocalComm
from ..core.plan import plan
from ..core.spec import CollectiveSpec


def capacity(cfg, n_tokens: int) -> int:
    """Per-expert slot count for an ``n_tokens`` pool: ``ceil(cf · N · K /
    E)`` rounded up to a multiple of 8, clamped to ``N·K`` and to at
    least 1."""
    n, k = n_tokens, cfg.experts_per_token
    c = int(cfg.capacity_factor * n * k / cfg.n_experts) + 1
    c = max(8, -(-c // 8) * 8)  # round up to multiple of 8
    return max(1, min(c, n * k))


# ---------------------------------------------------------------------------
# Stages (flat token pool)
# ---------------------------------------------------------------------------

def route(router_w: torch.Tensor, cfg, x: torch.Tensor):
    """Router stage.  ``x``: (*B, n, d) → (gate (*B, n, K) renormalized,
    expert_idx (*B, n, K), probs (*B, n, E) float32)."""
    logits = x.to(torch.float32) @ router_w
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, expert_idx, probs


def load_stats(cfg, probs: torch.Tensor, expert_idx: torch.Tensor):
    """The aux loss's two router statistics of one flat pool: the routed
    fraction per expert and the mean router probability per expert."""
    n, k = expert_idx.shape[-2], expert_idx.shape[-1]
    frac = F.one_hot(expert_idx, cfg.n_experts).to(torch.float32).sum(
        (-3, -2)) / (n * k)
    return frac, probs.mean(-2)


def aux_loss(cfg, probs: torch.Tensor, expert_idx: torch.Tensor
             ) -> torch.Tensor:
    """Switch-style load-balancing loss of one flat pool."""
    frac, mean_probs = load_stats(cfg, probs, expert_idx)
    return cfg.n_experts * torch.sum(frac * mean_probs) * cfg.router_aux_coef


def dispatch_tables(cfg, expert_idx: torch.Tensor, gate: torch.Tensor,
                    cap: int, n_experts: int | None = None):
    """Sort-based capacity dispatch over ONE flat pool.

    ``expert_idx``/``gate``: (n, K).  Returns ``(slot_token, slot_gate,
    routed)``: ``slot_token[e*cap + c]`` is the token filling slot c of
    expert e (``n``, the padded trash token, when empty), ``slot_gate``
    its renormalized router weight, and ``routed[e]`` (int32) the slots
    expert e filled (its count clipped to ``cap``).  ``n_experts``
    (default ``cfg.n_experts``) is the pool's expert count.
    """
    n, k = expert_idx.shape
    e = cfg.n_experts if n_experts is None else n_experts
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1).long()
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k, device=dev) - starts[sorted_e]
    slot = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e,
                       e * cap)                            # trash slot
    token_of = sort_idx // k
    gate_of = gate.reshape(-1)[sort_idx]
    slot_token = torch.full((e * cap + 1,), n, dtype=torch.long,
                            device=dev).index_put((slot,), token_of)
    slot_gate = gate.new_zeros(e * cap + 1).index_put((slot,), gate_of)
    return (slot_token[:-1], slot_gate[:-1],
            torch.clamp(counts, max=cap).to(torch.int32))


def gather_tokens(xf: torch.Tensor, slot_token: torch.Tensor, e: int,
                  cap: int) -> torch.Tensor:
    """Fill the (E, C, d) dispatch buffer: slot → token row (the trash
    token gathers a zero row, so unfilled slots are exactly zero)."""
    xpad = torch.cat([xf, xf.new_zeros((1, xf.shape[1]))])
    return xpad[slot_token].reshape(e, cap, xf.shape[1])


def expert_ffn(p: dict, h: torch.Tensor) -> torch.Tensor:
    """Batched expert SwiGLU.  ``h``: (*B, E, C, d) against stacked expert
    weights (E, d, ff); E lines up with the weights' leading axis."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", h, p["w_gate"]))
    u = torch.einsum("...ecd,edf->...ecf", h, p["w_up"])
    return torch.einsum("...ecf,efd->...ecd", g * u, p["w_down"])


def combine(y: torch.Tensor, slot_token: torch.Tensor,
            slot_gate: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-add expert outputs back to their tokens, gate-weighted.
    ``y``: (E, C, d) → (n, d).  With top-K each real token takes K adds
    into zero, which give the same bits in any order for K <= 2."""
    e_cap, d = y.shape[0] * y.shape[1], y.shape[2]
    yf = y.reshape(e_cap, d) * slot_gate[:, None].to(y.dtype)
    return y.new_zeros((n + 1, d)).index_add(0, slot_token, yf)[:n]


# ---------------------------------------------------------------------------
# moe_dispatch="global" — one flat pool
# ---------------------------------------------------------------------------

def moe_ffn_global(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, d) → (out (B, S, d), aux loss)."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    gate, expert_idx, probs = route(p["router"], cfg, xf)
    aux = aux_loss(cfg, probs, expert_idx)
    cap = capacity(cfg, n)
    slot_token, slot_gate, _ = dispatch_tables(cfg, expert_idx, gate, cap)
    h = gather_tokens(xf, slot_token, cfg.n_experts, cap)  # (E, C, d)
    y = expert_ffn(p, h)                                   # (E, C, d)
    return combine(y, slot_token, slot_gate, n).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# moe_dispatch="rowwise" — per-sequence pools
# ---------------------------------------------------------------------------

def moe_ffn_rowwise(p: dict, cfg, x: torch.Tensor):
    """Per-sequence dispatch (the reference's ``moe_ffn_rowwise``): x (B,
    S, d) → (out (B, S, d), aux loss).  Capacity is per sequence, ``C =
    capacity(cfg, S)``, and tokens drop per sequence (slightly stricter
    than one global pool; the same expected load).

    Every stage carries the batch dimension.  Sequence b's expert e is
    pool expert ``b·E + e`` of one flat dispatch over the ``B·S`` tokens:
    the stable sort orders by sequence, then expert, then token, exactly
    as B separate sorts would, and the slot of sequence b's expert e is
    ``(b·E + e)·C + c``, so the dispatch buffer reshapes to ``(B, E, C,
    d)`` with each sequence's slots its own.  The aux loss is the
    reference's: each sequence's Switch loss, averaged over the batch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, s)
    gate, expert_idx, probs = route(p["router"], cfg, x)   # (B, S, ·)
    frac, mean_probs = load_stats(cfg, probs, expert_idx)  # (B, E)
    aux = torch.mean(e * torch.sum(frac * mean_probs, dim=-1)) \
        * cfg.router_aux_coef
    offset = e * torch.arange(b, device=x.device).reshape(b, 1, 1)
    slot_token, slot_gate, _ = dispatch_tables(
        cfg, (expert_idx + offset).reshape(b * s, k),
        gate.reshape(b * s, k), cap, n_experts=b * e)
    h = gather_tokens(x.reshape(b * s, d), slot_token, b * e, cap)
    y = expert_ffn(p, h.reshape(b, e, cap, d))             # (B, E, C, d)
    out = combine(y.reshape(b * e, cap, d), slot_token, slot_gate, b * s)
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# moe_dispatch="ep" — expert parallelism over a communicator's ranks
# ---------------------------------------------------------------------------

def expert_owners(e: int, pe: int) -> tuple[int, ...]:
    """Experts owned per rank (contiguous blocks, low ranks get the
    remainder): ragged when ``e % pe != 0``."""
    base, rem = divmod(e, pe)
    return tuple(base + (j < rem) for j in range(pe))


def ep_collective_specs(cfg, pe: int, use_fused_kernel: bool | None = None
                        ) -> tuple[CollectiveSpec, CollectiveSpec]:
    """The :class:`CollectiveSpec` s ep dispatch executes over its
    ``pe`` ranks: the uniform circulant alltoall moving the padded
    dispatch buffer (out and back; ``use_fused_kernel`` as everywhere:
    ``None`` = ``permute_rows`` when the buffer lies on a card) and the
    ragged alltoallv moving the per-expert routed-token counts."""
    own = expert_owners(cfg.n_experts, pe)
    counts = tuple(own for _ in range(pe))   # [src][dst] = experts of dst
    return (CollectiveSpec(use_fused_kernel=use_fused_kernel),
            CollectiveSpec(counts=counts))


def _ep_pad_table(own: tuple[int, ...], pe: int, own_max: int) -> np.ndarray:
    """(pe, pe·own_max) gather table: padded (src, local-expert) slot →
    row of the rank's ragged alltoallv output (src-major, ``own[r]`` real
    experts per src), sentinel = the zero row appended past it."""
    out_h = max(pe * o for o in own)
    tab = np.full((pe, pe * own_max), out_h, dtype=np.int32)
    for r in range(pe):
        for src in range(pe):
            tab[r, src * own_max: src * own_max + own[r]] = np.arange(
                src * own[r], (src + 1) * own[r], dtype=np.int32)
    return tab


def _ep_expert_grid(own: tuple[int, ...], e: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Static index maps between the real contiguous expert numbering and
    the owner-padded grid (owner j holds padded slots [j·own_max,
    (j+1)·own_max), the first ``own[j]`` of them real).  Returns
    ``(pad_idx, inv_idx)``: ``pad_idx[slot]`` is the real expert filling
    a padded slot (``e``, a zero row, for phantom slots), ``inv_idx[x]``
    the padded slot of real expert x."""
    pe, own_max = len(own), max(own)
    off = np.concatenate([[0], np.cumsum(own)]).astype(np.int32)
    pad_idx = np.full(pe * own_max, e, dtype=np.int32)
    inv_idx = np.zeros(e, dtype=np.int32)
    for j in range(pe):
        for i in range(own[j]):
            pad_idx[j * own_max + i] = off[j] + i
            inv_idx[off[j] + i] = j * own_max + i
    return pad_idx, inv_idx


def moe_ffn_ep(ps: list, cfg, xs: list, comm,
               use_fused_kernel: bool | None = None):
    """Expert-parallel MoE dispatch over the ranks of ``comm`` (the
    reference's ``moe_ffn_ep`` over its manual axis ``cfg.ep_axis``).

    ``ps``/``xs``: per-local-rank MoE parameters (whole replicas; each
    rank slices its own experts) and ``(B, S, d)`` inputs.  Per call:
    route + dispatch locally; the ragged per-expert routed-token counts
    go to the owners over the alltoallv and the capacity-padded ``(E_pad,
    C, d)`` buffer over the circulant alltoall; each owner runs its
    experts on the gathered slots (masked to the routed counts, so
    phantom and over-capacity slots are exactly zero); the reverse
    alltoall brings the results back and each rank combines its own.
    The aux loss averages the router statistics over the ranks before
    the product (``all_reduce_sum / pe`` for the reference's ``pmean``),
    so it equals the single-pool loss.  Returns per-rank ``(outs,
    auxs)``.  Exchanges per call: ``3·ceil(log2 pe)``; with
    ``use_fused_kernel`` on, two ``permute_rows`` launches per rank.
    """
    if not isinstance(comm, LocalComm):
        raise NotImplementedError(
            "moe_dispatch='ep' runs over a LocalComm axis; over NCCL "
            "sub-groups (DistComm) it is not ported yet (ROADMAP.md queue "
            "1 item 11.1)")
    pe = comm.p
    e, k = cfg.n_experts, cfg.experts_per_token
    b, s, d = xs[0].shape
    n = b * s
    cap = capacity(cfg, n)
    own = expert_owners(e, pe)
    own_max = max(own)
    buf_spec, cnt_spec = ep_collective_specs(cfg, pe, use_fused_kernel)
    buf_plan, cnt_plan = plan(buf_spec, p=pe), plan(cnt_spec, p=pe)
    assert cnt_plan.a2a.in_height == e, (cnt_plan.a2a.in_height, e)
    pad_tab = _ep_pad_table(own, pe, own_max)
    pad_idx, inv_idx = _ep_expert_grid(own, e)
    off = np.concatenate([[0], np.cumsum(own)])
    dev = xs[0].device
    pad_idx_t = torch.as_tensor(pad_idx, dtype=torch.long, device=dev)
    inv_idx_t = torch.as_tensor(inv_idx, dtype=torch.long, device=dev)

    tables, blocks, routed, fracs, mprobs = [], [], [], [], []
    for p, x in zip(ps, xs):
        xf = x.reshape(n, d)
        gate, expert_idx, probs = route(p["router"], cfg, xf)
        frac, mp = load_stats(cfg, probs, expert_idx)
        fracs.append(frac)
        mprobs.append(mp)
        slot_token, slot_gate, cnt = dispatch_tables(cfg, expert_idx, gate,
                                                     cap)
        tables.append((slot_token, slot_gate))
        routed.append(cnt.reshape(e, 1))
        h = gather_tokens(xf, slot_token, e, cap)          # (E, C, d)
        hz = torch.cat([h, h.new_zeros((1, cap, d))])
        blocks.append(hz[pad_idx_t].reshape(pe, own_max * cap, d))
    # Aux loss on the GLOBAL pool statistics: both are linear in the
    # tokens, so averaging them over the ranks first reproduces the
    # single-pool loss.
    fracs = [f / pe for f in comm.all_reduce_sum(fracs)]
    mprobs = [m / pe for m in comm.all_reduce_sum(mprobs)]
    auxs = [e * torch.sum(f * m) * cfg.router_aux_coef
            for f, m in zip(fracs, mprobs)]

    # Routed counts to the owners (ragged alltoallv: one int32 row per
    # real expert, destination-ordered because ownership is contiguous).
    cnt_out = cnt_plan.alltoall(routed, comm)
    got = buf_plan.alltoall(blocks, comm)                  # row j = from j
    ys = []
    for p, c_out, g, r in zip(ps, cnt_out, got, comm.ranks):
        cz = torch.cat([c_out[:, 0], c_out.new_zeros(1)])
        cnt_grid = cz[torch.as_tensor(pad_tab[r], dtype=torch.long,
                                      device=dev)].reshape(pe, own_max)
        hloc = g.reshape(pe, own_max, cap, d)  # [src, local expert, slot]
        mask = torch.arange(cap, device=dev) < cnt_grid[..., None]
        hloc = torch.where(mask[..., None], hloc, torch.zeros_like(hloc))
        hloc = hloc.transpose(0, 1)            # (own_max, pe, C, d)
        # This rank's contiguous expert slice; phantom positions (ragged
        # ownership) clamp to a real expert, whose weights only ever meet
        # the zero rows masked above, so they add exactly zero.
        w_idx = torch.clamp(torch.arange(own_max, device=dev) + int(off[r]),
                            max=e - 1)
        w_loc = {key: p[key].index_select(0, w_idx)
                 for key in ("w_gate", "w_up", "w_down")}
        y = expert_ffn(w_loc, hloc.reshape(own_max, pe * cap, d))
        ys.append(y.reshape(own_max, pe, cap, d).transpose(0, 1)
                  .reshape(pe, own_max * cap, d))
    # Reverse exchange: owners return slots to their source ranks.
    back = buf_plan.alltoall(ys, comm)
    outs = []
    for (slot_token, slot_gate), bk in zip(tables, back):
        y_all = bk.reshape(pe * own_max, cap, d)[inv_idx_t]  # padded → real
        outs.append(combine(y_all, slot_token, slot_gate, n).reshape(b, s, d))
    return outs, auxs
