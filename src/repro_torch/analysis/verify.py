"""Static plan verifier: prove a compiled :class:`CollectivePlan` correct
without running a collective.  Ported from ``repro/analysis/verify.py``.

The paper's correctness claims are properties of the schedule, so they
are all checkable on the plan object alone, at any p, with no device:

* **Theorem 1** — the per-round send windows partition ``{1..p-1}``
  (every block leaves each rank exactly once) and the round count is
  ``len(get_skips(p, schedule))`` == ``ceil(log2 p)`` for the optimal
  schedules (2x for allreduce: RS + the reversed AG stack).
* **Deadlock-freedom** — every round's sends/recvs form one circulant
  permutation of the ranks: each rank sends exactly once and receives
  exactly once, matched pairs, no self-sends at p > 1 (``0 < skip <
  p``), and receives land only in still-live blocks (fold-liveness).
* **Corollary 3** — the non-uniform row tables are well-formed: a
  symbolic delivery simulation shows every rank's contribution to every
  destination row is folded exactly once, and each table's wire width
  equals the analytic worst-windowed-count-sum bound from
  ``cost_model.nonuniform_round_widths``.
* **Alltoall(v)** — the A2A round tables route every (src, dst) entry
  to its destination exactly once along the Bruck hop trajectories,
  with wire widths equal to ``cost_model.alltoallv_round_widths``.
* **Broadcast** (Träff, arXiv:2407.18004) — a block-level replay of the
  AG rounds shows every rank receives every block exactly once and ends
  holding all p blocks, in the schedule's round count.

All checks read the plan's OWN fields (``skips``, ``rs_rounds``,
``rs_send_blocks``, the row tables, ``a2a``), never regenerated ones, so
a corrupted plan (dropped skip, swapped table rows, inflated width,
duplicated send) is flagged, under the reference's rule names.  This is
the pre-flight that ``train.steps.build_zero1``, ``run_broadcast`` and
the elastic re-plan (``ft.elastic``) run before trusting a plan.
"""
from __future__ import annotations

import numpy as np

from ..core.cost_model import alltoallv_round_widths, nonuniform_round_widths
from ..core.plan import _BASELINE_KINDS, CollectivePlan, plan
from ..core.schedule import ceil_log2, get_skips, is_valid_schedule
from ..core.spec import CollectiveSpec
from .report import Finding

OPTIMAL_SCHEDULES = ("halving", "power2")   # exactly ceil(log2 p) rounds


def _finding(rule: str, where: str, message: str) -> Finding:
    return Finding(pass_name="verify", rule=rule, where=where,
                   message=message)


# ---------------------------------------------------------------------------
# Circulant structure: skips, rounds, permutations
# ---------------------------------------------------------------------------

def _check_rounds(pl: CollectivePlan, where: str) -> list[Finding]:
    p, spec = pl.p, pl.spec
    out: list[Finding] = []
    if not (len(pl.skips) == len(pl.rs_rounds) == len(pl.rs_send_blocks)
            == len(pl.rs_recv_blocks)):
        out.append(_finding(
            "round-structure", where,
            f"inconsistent round counts: {len(pl.skips)} skips, "
            f"{len(pl.rs_rounds)} rounds, {len(pl.rs_send_blocks)} send "
            f"windows, {len(pl.rs_recv_blocks)} recv windows"))
        return out  # downstream checks index by round
    if tuple(rp.skip for rp in pl.rs_rounds) != pl.skips:
        out.append(_finding(
            "round-structure", where,
            f"skips {pl.skips} disagree with round plans "
            f"{tuple(rp.skip for rp in pl.rs_rounds)}"))
    if pl.ag_rounds != tuple(reversed(pl.rs_rounds)):
        out.append(_finding(
            "ag-mirror", where,
            "allgather rounds are not the reversed reduce-scatter stack "
            "(Theorem 2 needs the AG phase to replay RS backwards)"))
    # Deadlock-freedom: each round is one circulant permutation —
    # rank i sends to (i + s) mod p, a bijection with no fixed point
    # whenever 0 < s < p.
    for k, s in enumerate(pl.skips):
        if not (0 < s < p):
            out.append(_finding(
                "self-send", where,
                f"round {k}: skip {s} outside (0, {p}) — rank i would "
                f"send to itself (deadlock/no-op at p>1)"))
            continue
        pairs = {(i, (i + s) % p) for i in range(p)}
        senders = {a for a, _ in pairs}
        receivers = {b for _, b in pairs}
        if senders != set(range(p)) or receivers != set(range(p)):
            out.append(_finding(
                "round-permutation", where,
                f"round {k}: skip {s} does not induce a permutation"))
    # Schedule validity: distinct decreasing skips ending in 1, every
    # 0 < i < p a sum of distinct skips, fold-liveness s_{k-1} <= 2 s_k.
    if p > 1 and not is_valid_schedule(p, pl.skips):
        out.append(_finding(
            "schedule-invalid", where,
            f"skips {pl.skips} violate the Corollary 2 preconditions "
            f"(distinct decreasing, last=1, subset-sum reach, "
            f"fold-liveness) at p={p}"))
    # Round optimality: the plan must carry exactly the schedule's
    # rounds; for the optimal schedules that is ceil(log2 p) (Theorem 1),
    # and allreduce = RS + reversed AG = 2 ceil(log2 p) (Theorem 2).
    want = len(get_skips(p, spec.schedule, group=spec.group))
    if len(pl.skips) != want:
        out.append(_finding(
            "round-count", where,
            f"{len(pl.skips)} RS rounds, schedule {spec.schedule!r} "
            f"defines {want}"))
    if spec.schedule in OPTIMAL_SCHEDULES and p > 1:
        q = ceil_log2(p)
        if len(pl.rs_rounds) != q:
            out.append(_finding(
                "round-count", where,
                f"{len(pl.rs_rounds)} RS rounds != ceil(log2 {p}) = {q}"))
        if len(pl.rs_rounds) + len(pl.ag_rounds) != 2 * q:
            out.append(_finding(
                "round-count", where,
                f"allreduce rounds {len(pl.rs_rounds)}+{len(pl.ag_rounds)}"
                f" != 2*ceil(log2 {p}) = {2 * q}"))
    return out


def _check_partition(pl: CollectivePlan, where: str) -> list[Finding]:
    """Theorem 1: the RS send windows partition {1..p-1} exactly."""
    p = pl.p
    out: list[Finding] = []
    seen: set[int] = set()
    for k, win in enumerate(pl.rs_send_blocks):
        wset = set(win)
        if len(wset) != len(win):
            out.append(_finding(
                "duplicate-send", where,
                f"round {k}: send window {win} repeats a block"))
        dup = seen & wset
        if dup:
            out.append(_finding(
                "duplicate-send", where,
                f"round {k}: blocks {sorted(dup)} already sent in an "
                f"earlier round (each block must leave a rank once)"))
        seen |= wset
    if p > 1 and seen != set(range(1, p)):
        missing = sorted(set(range(1, p)) - seen)
        extra = sorted(seen - set(range(1, p)))
        out.append(_finding(
            "theorem1-partition", where,
            f"send windows do not partition {{1..{p - 1}}}: "
            f"missing {missing}, out-of-range {extra}"))
    for k, (rp, win, recv) in enumerate(zip(pl.rs_rounds, pl.rs_send_blocks,
                                            pl.rs_recv_blocks)):
        if tuple(win) != tuple(range(rp.lo, rp.hi)):
            out.append(_finding(
                "window-mismatch", where,
                f"round {k}: send window {win} != contiguous "
                f"[{rp.lo}, {rp.hi})"))
        if tuple(recv) != tuple(range(0, len(tuple(win)))):
            out.append(_finding(
                "window-mismatch", where,
                f"round {k}: recv window {recv} must be "
                f"[0, {len(tuple(win))})"))
    return out


def _check_delivery(pl: CollectivePlan, where: str) -> list[Finding]:
    """Symbolic fold replay of the RS rounds (rank-rotated offsets).

    ``shape[j]`` = set of source offsets folded into rotated block j;
    a duplicate fold or a fold into an already-sent block is flagged,
    and at the end block 0 must hold every source exactly once.
    """
    p = pl.p
    if p == 1 or len(pl.skips) != len(pl.rs_send_blocks):
        return []
    out: list[Finding] = []
    shape: list[set[int]] = [{0} for _ in range(p)]
    dead: set[int] = set()
    for k, (s, win) in enumerate(zip(pl.skips, pl.rs_send_blocks)):
        if not (0 < s < p):
            return out  # already flagged by round-permutation
        for j in win:
            if not (0 <= j < p):
                out.append(_finding(
                    "window-mismatch", where,
                    f"round {k}: send block {j} out of range [0, {p})"))
                continue
            if j in dead:
                out.append(_finding(
                    "duplicate-send", where,
                    f"round {k}: block {j} re-sent after leaving the "
                    f"live buffer (its partial sum is stale)"))
                continue
            tgt = j - s
            if tgt < 0:
                out.append(_finding(
                    "fold-target", where,
                    f"round {k}: block {j} with skip {s} folds into "
                    f"negative offset {tgt}"))
                continue
            if tgt in dead or tgt in win:
                out.append(_finding(
                    "fold-liveness", where,
                    f"round {k}: block {j} folds into {tgt}, which is "
                    f"dead or leaving this round (contribution lost)"))
                continue
            inc = {(o - s) % p for o in shape[j]}
            dup = shape[tgt] & inc
            if dup:
                out.append(_finding(
                    "duplicate-contribution", where,
                    f"round {k}: sources {sorted(dup)} folded into "
                    f"block {tgt} twice"))
            shape[tgt] |= inc
        dead |= {j for j in win if 0 <= j < p}
    if shape[0] != set(range(p)):
        missing = sorted(set(range(p)) - shape[0])
        out.append(_finding(
            "incomplete-reduction", where,
            f"final block holds {len(shape[0])}/{p} contributions; "
            f"missing source offsets {missing}"))
    return out


def _check_broadcast(pl: CollectivePlan, where: str) -> list[Finding]:
    """Block-level replay of the AG rounds in absolute coordinates.

    ``have[r]`` = absolute blocks held by rank r (initially its own).
    Round k with skip s ships rank r's rotated prefix to (r - s) mod p;
    rotated index i on rank r is absolute block (r + i) mod p.  Every
    send must be held, every delivery must be NEW (the broadcast paper's
    exactly-once invariant), and all ranks must end with all p blocks.
    """
    p = pl.p
    out: list[Finding] = []
    if len(pl.ag_rounds) != len(pl.ag_send_blocks) or \
            len(pl.ag_rounds) != len(pl.ag_recv_blocks):
        out.append(_finding(
            "round-structure", where,
            f"inconsistent ag structure: {len(pl.ag_rounds)} rounds, "
            f"{len(pl.ag_send_blocks)} send windows, "
            f"{len(pl.ag_recv_blocks)} recv windows"))
        return out
    have = [{r} for r in range(p)]
    for k, (rp, win, recv) in enumerate(zip(pl.ag_rounds, pl.ag_send_blocks,
                                            pl.ag_recv_blocks)):
        s = rp.skip
        if not (0 < s < p):
            return out  # already flagged by self-send
        if tuple(recv) != tuple(i + s for i in win):
            out.append(_finding(
                "window-mismatch", where,
                f"ag round {k}: recv window {recv} is not the send "
                f"window shifted by skip {s}"))
        moved = []
        for r in range(p):
            blocks = {(r + i) % p for i in win}
            miss = blocks - have[r]
            if miss:
                out.append(_finding(
                    "send-before-receive", where,
                    f"ag round {k}: rank {r} sends blocks {sorted(miss)} "
                    f"it does not hold yet"))
            moved.append((r, (r - s) % p, blocks))
        for src, dst, blocks in moved:
            dup = blocks & have[dst]
            if dup:
                out.append(_finding(
                    "duplicate-delivery", where,
                    f"ag round {k}: rank {dst} receives blocks "
                    f"{sorted(dup)} it already holds (every rank must "
                    f"receive every block exactly once)"))
            have[dst] |= blocks
    full = set(range(p))
    for r in range(p):
        if have[r] != full:
            miss = sorted(full - have[r])
            out.append(_finding(
                "incomplete-broadcast", where,
                f"rank {r} ends holding {len(have[r])}/{p} blocks; "
                f"missing {miss[:8]}"))
    return out


# ---------------------------------------------------------------------------
# Non-uniform (Corollary 3) row tables
# ---------------------------------------------------------------------------

def _table_rows(tab: np.ndarray, r: int, sentinel: int,
                where: str, k: int, out: list[Finding]) -> list[int]:
    rows = []
    for v in tab[r].tolist():
        if v == sentinel:
            continue
        if not (0 <= v < sentinel):
            out.append(_finding(
                "table-range", where,
                f"round {k}: table row {r} holds {v}, outside "
                f"[0, {sentinel}]"))
            continue
        rows.append(v)
    return rows


def _check_nonuniform(pl: CollectivePlan, where: str) -> list[Finding]:
    layout, p = pl.layout, pl.p
    out: list[Finding] = []
    counts, offs, N = layout.counts, layout.offsets, layout.total
    spec = pl.spec

    for phase, tables in (("rs", pl.rs_row_tables),
                          ("ag", pl.ag_row_tables)):
        if tables is None:
            out.append(_finding(
                "table-missing", where,
                f"non-uniform plan carries no {phase} row tables"))
            continue
        want = nonuniform_round_widths(counts, spec.schedule, spec.group,
                                       phase=phase)
        got = tuple(t.shape[1] for t in tables)
        if got != want:
            out.append(_finding(
                "width-bound", where,
                f"{phase} table widths {got} != analytic worst-windowed-"
                f"count-sum bound {want} (Corollary 3)"))
        for k, t in enumerate(tables):
            if t.shape[0] != p:
                out.append(_finding(
                    "table-shape", where,
                    f"{phase} round {k}: table has {t.shape[0]} rows "
                    f"for axis size {p}"))

    if out or len(pl.skips) != len(pl.rs_row_tables or ()):
        return out

    # RS delivery: contrib[r][row] = source ranks folded into buffer row
    # `row` on rank r.  Receiver (r + s) folds the sender's rows through
    # ITS view of the same table — exactly what _rs_nonuniform executes.
    contrib = [{row: {r} for row in range(N)} for r in range(p)]
    for k, s in enumerate(pl.skips):
        tab = pl.rs_row_tables[k]
        moved = []
        for r in range(p):
            rows = _table_rows(tab, r, N, where, k, out)
            if len(rows) != len(set(rows)):
                out.append(_finding(
                    "duplicate-send", where,
                    f"rs round {k}: table row {r} gathers a buffer row "
                    f"twice"))
            moved.append((r, (r + s) % p, rows))
        for src, dst, rows in moved:
            for row in rows:
                payload = contrib[src][row]
                dup = contrib[dst][row] & payload
                if dup:
                    out.append(_finding(
                        "duplicate-contribution", where,
                        f"rs round {k}: ranks {sorted(dup)} contribute "
                        f"row {row} to rank {dst} twice"))
                contrib[dst][row] |= payload
    full = set(range(p))
    for r in range(p):
        own = range(offs[r], offs[r] + counts[r])
        short = [row for row in own if contrib[r][row] != full]
        if short:
            out.append(_finding(
                "incomplete-reduction", where,
                f"rank {r}: rows {short[:8]} of its own block miss "
                f"contributions after all rs rounds"))

    # AG delivery: have[r] = blocks held; every send must be held, every
    # receive new, and all ranks must end with every block.
    if pl.ag_row_tables is not None and len(pl.ag_rounds) == len(
            pl.ag_row_tables):
        # Zero-count blocks carry no rows: they are vacuously gathered
        # and never appear in a table, so track only non-empty blocks.
        nonempty = {b for b in range(p) if counts[b] > 0}
        have = [{r} & nonempty for r in range(p)]
        block_of = {}
        for b in range(p):
            for row in range(offs[b], offs[b] + counts[b]):
                block_of[row] = b
        for k, rp in enumerate(pl.ag_rounds):
            tab = pl.ag_row_tables[k]
            s = rp.skip
            moved = []
            for r in range(p):
                rows = _table_rows(tab, r, N, where, k, out)
                blocks = {block_of[row] for row in rows}
                miss = blocks - have[r]
                if miss:
                    out.append(_finding(
                        "send-before-receive", where,
                        f"ag round {k}: rank {r} sends blocks "
                        f"{sorted(miss)} it does not hold yet"))
                # Completeness: the gathered rows must cover each sent
                # block entirely (a dropped row truncates the block).
                rowset = set(rows)
                for b in blocks & have[r]:
                    whole = set(range(offs[b], offs[b] + counts[b]))
                    if not whole <= rowset:
                        out.append(_finding(
                            "partial-block", where,
                            f"ag round {k}: rank {r} sends only part of "
                            f"block {b}"))
                moved.append((r, (r - s) % p, blocks))
            for src, dst, blocks in moved:
                for b in blocks:
                    if b in have[dst] and b != dst:
                        out.append(_finding(
                            "duplicate-delivery", where,
                            f"ag round {k}: rank {dst} receives block "
                            f"{b} it already holds"))
                have[dst] |= blocks
        for r in range(p):
            if have[r] != nonempty:
                out.append(_finding(
                    "incomplete-gather", where,
                    f"rank {r} ends the ag phase holding "
                    f"{len(have[r])}/{len(nonempty)} non-empty blocks"))
    return out


# ---------------------------------------------------------------------------
# Alltoall(v) round tables
# ---------------------------------------------------------------------------

def _check_a2a(pl: CollectivePlan, where: str) -> list[Finding]:
    a2a, p, spec = pl.a2a, pl.p, pl.spec
    out: list[Finding] = []
    counts = a2a.counts
    total = a2a.total

    want = alltoallv_round_widths(counts, spec.schedule, spec.group)
    if a2a.round_widths != want:
        out.append(_finding(
            "width-bound", where,
            f"alltoallv round widths {a2a.round_widths} != analytic "
            f"worst-windowed-count-sum bound {want}"))
    if len(a2a.round_tables) != len(pl.skips):
        out.append(_finding(
            "round-structure", where,
            f"{len(a2a.round_tables)} a2a round tables for "
            f"{len(pl.skips)} rounds"))
        return out

    offs = a2a.pair_offsets
    row_pair = {}
    for s in range(p):
        for d in range(p):
            for row in range(int(offs[s, d]), int(offs[s, d]) + counts[s][d]):
                row_pair[row] = (s, d)

    # Seed well-formedness: rank r must place exactly its own (r, *)
    # rows into the pair layout.
    for r in range(p):
        dst_rows = [int(v) for v in a2a.seed_dst[r] if v != total]
        own = [row for row in range(total) if row_pair[row][0] == r]
        if sorted(dst_rows) != own:
            out.append(_finding(
                "seed-mismatch", where,
                f"rank {r} seeds rows other than its own (src={r}) "
                f"pair rows"))

    # Hop replay: held[r] = buffer rows present on rank r.  Each round's
    # gather must be held, each delivery must be new.
    held = [set(int(v) for v in a2a.seed_dst[r] if v != total)
            for r in range(p)]
    for k, (s, tab) in enumerate(zip(pl.skips, a2a.round_tables)):
        moved = []
        for r in range(p):
            rows = _table_rows(tab, r, total, where, k, out)
            if len(rows) != len(set(rows)):
                out.append(_finding(
                    "duplicate-send", where,
                    f"a2a round {k}: table row {r} gathers a buffer row "
                    f"twice"))
            miss = set(rows) - held[r]
            if miss:
                out.append(_finding(
                    "send-before-receive", where,
                    f"a2a round {k}: rank {r} forwards rows it does not "
                    f"hold (e.g. {sorted(miss)[:4]})"))
            moved.append((r, (r + s) % p, set(rows)))
        for src, dst, rows in moved:
            dup = rows & held[dst]
            if dup:
                out.append(_finding(
                    "duplicate-delivery", where,
                    f"a2a round {k}: rank {dst} receives rows it "
                    f"already holds (e.g. {sorted(dup)[:4]})"))
            held[dst] |= rows
    for r in range(p):
        need = {row for row in range(total) if row_pair[row][1] == r}
        miss = need - held[r]
        if miss:
            out.append(_finding(
                "undelivered-entry", where,
                f"rank {r} never receives its (src,dst={r}) rows "
                f"(e.g. {sorted(miss)[:4]})"))
        out_rows = [int(v) for v in a2a.out_rows[r] if v != total]
        if sorted(out_rows) != sorted(need):
            out.append(_finding(
                "output-gather", where,
                f"rank {r}'s output gather rows do not equal its "
                f"destination pair rows"))
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def verify_plan(pl: CollectivePlan) -> list[Finding]:
    """All static checks applicable to ``pl``; [] == verified."""
    where = f"{pl.spec.label}@p={pl.p}"
    if pl.spec.kind in _BASELINE_KINDS:
        return []  # baselines carry no circulant structure to verify
    if pl.p == 1:
        return []
    out = _check_rounds(pl, where)
    out += _check_partition(pl, where)
    if pl.spec.kind == "broadcast":
        # Broadcast runs the AG phase only: the delivery claim is the
        # block-level exactly-once replay, not the RS fold simulation.
        return out + _check_broadcast(pl, where)
    out += _check_delivery(pl, where)
    if pl.layout is not None:
        out += _check_nonuniform(pl, where)
    if pl.a2a is not None:
        out += _check_a2a(pl, where)
    return out


def verify(spec: CollectiveSpec | None = None, p: int | None = None,
           **kw) -> list[Finding]:
    """Build (or fetch the cached) plan for ``spec`` x ``p`` and verify."""
    return verify_plan(plan(spec, p=p, **kw))


def assert_verified(pl: CollectivePlan) -> CollectivePlan:
    """Pre-flight hook: raise if ``pl`` fails any static check.

    Cheap (set arithmetic on the plan's tables, no device): callers that
    build plans (``build_zero1``, the elastic re-plan) run it before
    trusting a fresh plan.  Every call adds one to
    ``assert_verified.calls``.
    """
    assert_verified.calls += 1
    findings = verify_plan(pl)
    if findings:
        raise AssertionError(
            "plan failed static verification:\n  "
            + "\n  ".join(f.render() for f in findings))
    return pl


assert_verified.calls = 0


def registry_specs(p: int) -> list[CollectiveSpec]:
    """Representative spec registry for the sweep: every backend family
    x schedule, plus the conformance count patterns for the ragged
    forms."""
    from ..core.conformance import (alltoallv_counts_cases,
                                        nonuniform_counts_cases,
                                        two_level_group)

    specs = []
    for sched in ("halving", "power2", "fully_connected", "sqrt"):
        specs.append(CollectiveSpec(schedule=sched))
    specs.append(CollectiveSpec(schedule="two_level",
                                group=two_level_group(p)))
    specs.append(CollectiveSpec(use_fused_kernel=True))
    specs.append(CollectiveSpec(wire_dtype="int8"))
    specs.append(CollectiveSpec(op="max"))
    for counts in nonuniform_counts_cases(p).values():
        specs.append(CollectiveSpec(counts=counts))
    for counts in alltoallv_counts_cases(p).values():
        specs.append(CollectiveSpec(counts=counts))
    for sched in OPTIMAL_SCHEDULES:
        specs.append(CollectiveSpec(kind="broadcast", schedule=sched))
    for kind in _BASELINE_KINDS:
        specs.append(CollectiveSpec(kind=kind))
    return specs


def run(ps=(2, 3, 5, 8, 16)) -> list[Finding]:
    """Verify the full spec registry at every ``p``; [] == all clean.
    A plan whose construction raises is a ``plan-build-error`` finding."""
    findings: list[Finding] = []
    for p in ps:
        for spec in registry_specs(p):
            try:
                findings += verify(spec, p=p)
            except Exception as e:  # plan construction itself failed
                findings.append(_finding(
                    "plan-build-error", f"{spec.label}@p={p}",
                    f"{type(e).__name__}: {e}"))
    return findings
