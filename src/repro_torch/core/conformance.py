"""Conformance harness of the port's circulant collectives.

The port's counterpart of ``repro/core/conformance.py``, run in one
process on a :class:`~repro_torch.comm.LocalComm` of p virtual ranks, on
the card or on the CPU.  It sweeps every meaningful (collective ×
schedule × op × dtype × use_fused_kernel × wire_dtype) combination of
the circulant kind at axis size ``p`` (int8-wire mirrors with the
reference's quantization-aware tolerances, everything else exact), the
Corollary-3 non-uniform counts (``run_nonuniform``) and the alltoall(v)
(``run_alltoall``).  Per case it asserts:

  (a) agreement with a host numpy reference: bitwise for integer and
      max/min reductions, within the reference's tolerances for float
      sums; the allreduce replicated bitwise on every rank;
  (b) off the wire, for float32 and int32, bitwise agreement with the
      message-passing simulator (``core/simulator.py``): the port folds
      in the schedule's order, as the simulator does;
  (c) ``comm.exchanges`` (the port's stand-in for the reference's HLO
      collective-permute count): exactly ``rounds(schedule)`` per
      reduce-scatter and twice that per allreduce, with ``rounds ==
      ceil_log2(p)`` for halving / power2 (Theorems 1 and 2), fused and
      on the wire alike; and ``comm.bytes`` equal to the rows the plan
      ships, ``nonuniform_round_widths`` / ``alltoallv_round_widths``
      for the ragged forms.

The reference's ring / recursive-halving / xla baselines, its broadcast,
hierarchical and elastic re-plan sweeps are not ported yet (ROADMAP.md
queue 1 items 14, 9, 9 and 11).  Run::

    python -m repro_torch.core.conformance <p> [--device cpu]

On the card unless ``--device cpu`` is given; without a card it refuses
rather than fall back to the CPU.
"""
from __future__ import annotations

import argparse
import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..comm import LocalComm, resolve_device
from ..kernels.quantize import wire_width
from . import collectives as C
from . import simulator as sim
from .cost_model import alltoallv_round_widths, nonuniform_round_widths
from .plan import plan
from .schedule import ceil_log2, get_skips
from .spec import CollectiveSpec

# Non-powers-of-two dominate by design — power-of-two p is the case the
# classic algorithms already handle; the paper's claim is the general one.
DEFAULT_PS = (2, 3, 4, 5, 6, 7, 8, 12, 16)
SCHEDULES = ("halving", "power2", "fully_connected", "sqrt", "two_level")
OPTIMAL_SCHEDULES = ("halving", "power2")   # exactly ceil(log2 p) rounds
OPS = ("add", "max", "min")
DTYPES = ("float32", "bfloat16", "int32")
NONUNIFORM_SCHEDULES = ("halving", "power2", "fully_connected")
A2A_SCHEDULES = ("halving", "power2", "fully_connected")
A2A_DTYPES = ("float32", "bfloat16", "int32")

BLK = 4  # elements per block — tiny on purpose

_NP_OPS = {"add": np.add, "max": np.maximum, "min": np.minimum}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32}


def two_level_group(p: int) -> int:
    """Intra-group size for the two_level schedule: the divisor of p
    nearest sqrt(p).  1 for primes (two_level degenerates to halving)."""
    divisors = [d for d in range(2, p) if p % d == 0]
    if not divisors:
        return 1
    return min(divisors, key=lambda d: (abs(d - math.sqrt(p)), d))


def _group(p: int, schedule: str) -> int | None:
    return two_level_group(p) if schedule == "two_level" else None


def schedule_rounds(p: int, schedule: str) -> int:
    """Round count of ``schedule`` at ``p`` ranks (two_level resolves
    its group size first)."""
    return len(get_skips(p, schedule, group=_group(p, schedule)))


@dataclass(frozen=True)
class Case:
    """One conformance-matrix cell: a (collective, schedule, op, dtype,
    fused, wire) combination of the circulant kind."""
    collective: str            # reduce_scatter | allreduce
    impl: str = "circulant"    # the only ported kind
    schedule: str = "halving"
    op: str = "add"
    dtype: str = "float32"
    fused: bool = False        # use_fused_kernel
    wire: str | None = None    # wire_dtype (float dtypes)

    @property
    def label(self) -> str:
        tag = (":fused" if self.fused else "") + \
            (f":wire={self.wire}" if self.wire else "")
        return (f"{self.collective}[{self.impl}:{self.schedule}"
                f":{self.op}:{self.dtype}{tag}]")


def sweep_cases(p: int) -> list[Case]:
    """Every meaningful circulant combination for axis size p,
    deduplicated: both collectives at the defaults, then schedule / op /
    dtype sweeps.  Every case is mirrored with ``use_fused_kernel=True``
    and every float case (fused and not) with ``wire_dtype="int8"``."""
    cases: list[Case] = []
    for coll in ("reduce_scatter", "allreduce"):
        base = [Case(coll)]
        base.extend(Case(coll, schedule=s) for s in SCHEDULES
                    if s != "halving")
        base.extend(Case(coll, op=op) for op in OPS if op != "add")
        base.extend(Case(coll, dtype=dt) for dt in DTYPES
                    if dt != "float32")
        base.extend(Case(c.collective, c.impl, c.schedule, c.op, c.dtype,
                         fused=True) for c in list(base))
        base.extend(Case(c.collective, c.impl, c.schedule, c.op, c.dtype,
                         fused=c.fused, wire="int8")
                    for c in list(base) if c.dtype != "int32")
        cases.extend(base)
    return cases


def case_spec(case: Case, p: int) -> CollectiveSpec:
    """The CollectiveSpec a sweep case means — every case executes
    through the plan/execute API."""
    return CollectiveSpec(kind=case.impl, schedule=case.schedule, op=case.op,
                          use_fused_kernel=case.fused, wire_dtype=case.wire,
                          group=_group(p, case.schedule))


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 values (held as float32)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _make_input(case: Case, p: int, rng: np.random.Generator) -> np.ndarray:
    n = p * BLK
    if case.dtype == "int32":
        return rng.integers(-50, 50, size=(p, n), dtype=np.int64).astype(
            np.int32)
    x = rng.standard_normal((p, n)).astype(np.float32)
    if case.dtype == "bfloat16":
        x = _bf16_exact(x)
    return x


def _reference(case: Case, xg: np.ndarray) -> np.ndarray:
    """Host ground truth: op-fold over ranks (float64 accumulation for
    float inputs; exact dtype for integers)."""
    npop = _NP_OPS[case.op]
    work = xg.astype(np.float64) if case.dtype != "int32" else xg
    red = work[0]
    for r in range(1, xg.shape[0]):
        red = npop(red, work[r])
    return red


def _tolerances(case: Case, p: int) -> dict:
    """The reference's tolerances (``repro/core/conformance.py``)."""
    if case.wire == "int8":
        # Quantization-bounded, not bitwise (even for max/min): every
        # round requantizes partial sums.
        return {"rtol": 0.1, "atol": 0.05 * p + 0.1}
    if case.dtype == "int32" or case.op in ("max", "min"):
        return {"rtol": 0, "atol": 0}
    if case.dtype == "bfloat16":
        return {"rtol": 0.05, "atol": 0.05 * p}
    return {"rtol": 2e-5, "atol": 2e-5}


def _to_ranks(xg: np.ndarray, dtype: torch.dtype, device) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)
            for a in xg]


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def run_case(p: int, case: Case, rng: np.random.Generator,
             device="cuda") -> None:
    """Execute one case and assert agreement; raises AssertionError with
    the case label on any mismatch."""
    device = resolve_device(device)
    xg = _make_input(case, p, rng)
    xs = _to_ranks(xg, _TORCH_DTYPES[case.dtype], device)
    spec = case_spec(case, p)
    fn = C.reduce_scatter if case.collective == "reduce_scatter" \
        else C.allreduce
    out = np.stack([_host(o) for o in fn(xs, LocalComm(p), spec=spec)])
    ref = _reference(case, xg)
    tol = _tolerances(case, p)
    try:
        if case.collective == "reduce_scatter":
            ref_blocks = ref.reshape(p, BLK)
            for r in range(p):
                np.testing.assert_allclose(
                    out[r].astype(np.float64), ref_blocks[r], **tol)
        else:
            for r in range(p):
                np.testing.assert_allclose(
                    out[r].astype(np.float64), ref, **tol)
                # Theorem 2's output is REPLICATED — bitwise, not just close.
                np.testing.assert_array_equal(out[r], out[0])
    except AssertionError as e:
        raise AssertionError(f"{case.label} vs host reference (p={p}): {e}") \
            from None
    if case.wire is not None or case.dtype == "bfloat16":
        return
    # Same fold order as the simulator: bitwise, add included.
    inputs = [[xg[r, i * BLK:(i + 1) * BLK] for i in range(p)]
              for r in range(p)]
    group = _group(p, case.schedule)
    if case.collective == "reduce_scatter":
        W, _ = sim.simulate_reduce_scatter(inputs, _NP_OPS[case.op],
                                           case.schedule, group)
        want = np.stack(W)
    else:
        W, _ = sim.simulate_allreduce(inputs, _NP_OPS[case.op],
                                      case.schedule, group)
        want = np.stack([np.concatenate(row) for row in W])
    if not _same_bits(out, want):
        raise AssertionError(f"{case.label} differs from the simulator "
                             f"bitwise (p={p})")


def check_round_counts(p: int, device="cuda") -> dict[str, tuple]:
    """Assert RS/AR exchange and byte counts for every schedule, eager
    and fused, exact and on the int8 wire (neither fusion nor compression
    may change the communication structure: one exchange per round);
    returns ``{schedule[:fused][:w8]: (n_rs, n_ar, bytes_rs, bytes_ar)}``
    for an f32 ``(p * BLK,)`` payload per rank."""
    device = resolve_device(device)
    xs = _to_ranks(np.ones((p, p * BLK), np.float32), torch.float32, device)
    results = {}
    for sched in SCHEDULES:
        rounds = schedule_rounds(p, sched)
        if sched in OPTIMAL_SCHEDULES:
            assert rounds == ceil_log2(p), \
                f"{sched} must be a ceil(log2 p)-round schedule (p={p})"
        for fused in (False, True):
            for wire in (None, "int8"):
                kw = dict(schedule=sched, group=_group(p, sched),
                          use_fused_kernel=fused, wire_dtype=wire)
                tag = sched + (":fused" if fused else "") + \
                    (":w8" if wire else "")
                # p - 1 block rows leave each rank per phase (Theorem 1);
                # on the wire a BLK-element row is one quantization group.
                row = wire_width(BLK, BLK) if wire else BLK * 4
                want_bytes = p * (p - 1) * row
                rs_comm, ar_comm = LocalComm(p), LocalComm(p)
                C.circulant_reduce_scatter(xs, rs_comm, **kw)
                C.circulant_allreduce(xs, ar_comm, **kw)
                got = (rs_comm.exchanges, ar_comm.exchanges,
                       rs_comm.bytes, ar_comm.bytes)
                assert got == (rounds, 2 * rounds, want_bytes,
                               2 * want_bytes), \
                    (f"{tag} p={p}: (RS, AR) exchanges and bytes {got}, "
                     f"want {(rounds, 2 * rounds)} exchanges (Theorems 1 "
                     f"and 2) and {(want_bytes, 2 * want_bytes)} bytes")
                results[tag] = got
    return results


# ---------------------------------------------------------------------------
# Non-uniform counts (paper Corollary 3) — spec(counts=...) vs simulator
# ---------------------------------------------------------------------------

def nonuniform_counts_cases(p: int) -> dict[str, tuple[int, ...]]:
    """Per-rank block-size patterns for the Corollary 3 sweep.

    ``one_column`` is the paper's worst case (every element concentrated
    in a single column — each round one rank ships the whole vector);
    ``zero_ranks`` exercises empty blocks; ``ragged`` is a deterministic
    mixed pattern; ``uniform`` must agree with the uniform path.
    """
    ragged = tuple((i * 5 + 3) % 7 for i in range(p))
    if sum(ragged) == 0:
        ragged = (1,) * p
    one_col = [0] * p
    one_col[p // 2] = 4 * p + 3
    zero_ranks = tuple(0 if i % 2 else i + 2 for i in range(p))
    if sum(zero_ranks) == 0:
        zero_ranks = (2,) + (0,) * (p - 1)
    return {
        "ragged": ragged,
        "one_column": tuple(one_col),
        "zero_ranks": zero_ranks,
        "uniform": (BLK,) * p,
    }


def _ref_nonuniform(xg: np.ndarray, op: str) -> np.ndarray:
    npop = _NP_OPS[op]
    red = xg[0].astype(np.float64)
    for r in range(1, xg.shape[0]):
        red = npop(red, xg[r].astype(np.float64))
    return red


def run_nonuniform(p: int, device="cuda", verbose: bool = False) -> dict:
    """Corollary 3 conformance: ``CollectiveSpec(counts=...)``
    reduce-scatter across schedules × ops × counts patterns, bitwise
    equal to the simulator (which asserts the Theorem 1 counters) and
    close to the host reference, zero past each rank's count, with
    exactly ``rounds(schedule)`` exchanges (ragged counts do not change
    the communication structure) and ``nonuniform_round_widths`` rows
    per round and rank on the wire; the row tables have exactly those
    widths.  Then the allreduce on the default schedule: replicated
    bitwise, ``2 * rounds`` exchanges, the RS and AG widths' bytes."""
    device = resolve_device(device)
    rng = np.random.default_rng(4242 + p)
    n_cases = 0
    rounds: dict[str, tuple[int, int]] = {}
    for name, counts in nonuniform_counts_cases(p).items():
        N, bmax = sum(counts), max(counts)
        offs = np.concatenate([[0], np.cumsum(counts)])
        xg = rng.standard_normal((p, N)).astype(np.float32)
        xs = _to_ranks(xg, torch.float32, device)
        inputs = [[xg[r, offs[i]:offs[i + 1]] for i in range(p)]
                  for r in range(p)]
        ref = {op: _ref_nonuniform(xg, op) for op in ("add", "max")}
        for sched in NONUNIFORM_SCHEDULES:
            want = schedule_rounds(p, sched)
            if sched in OPTIMAL_SCHEDULES:
                assert want == ceil_log2(p)
            widths = nonuniform_round_widths(counts, sched)
            for op in ("add", "max"):
                spec = CollectiveSpec(schedule=sched, op=op, counts=counts)
                tag = f"counts[{name}:{sched}:{op}]"
                W, stats = sim.simulate_reduce_scatter(
                    inputs, op=_NP_OPS[op], schedule=sched)
                if sched in OPTIMAL_SCHEDULES:
                    stats.assert_theorem1(p)
                else:
                    assert stats.rounds == want
                    assert all(b == p - 1 for b in stats.blocks_sent)
                comm = LocalComm(p)
                pl = plan(spec, p=p)
                assert tuple(t.shape[1] for t in pl.rs_row_tables) == \
                    widths, f"{tag}: row table widths vs cost model"
                out = [_host(o) for o in pl.reduce_scatter(xs, comm)]
                assert comm.exchanges == want, \
                    (f"{tag} p={p}: {comm.exchanges} exchanges, want "
                     f"{want} (Corollary 3 keeps Theorem 1's rounds)")
                assert comm.bytes == sum(widths) * 4 * p, \
                    f"{tag} p={p}: {comm.bytes} bytes, widths {widths}"
                tol = ({"rtol": 0, "atol": 0} if op != "add"
                       else {"rtol": 2e-5, "atol": 2e-5})
                for r in range(p):
                    c = counts[r]
                    assert out[r].shape == (bmax,)
                    assert _same_bits(out[r][:c], W[r]), \
                        f"{tag} vs simulator bitwise (p={p}, rank {r})"
                    np.testing.assert_allclose(
                        out[r][:c].astype(np.float64),
                        ref[op][offs[r]:offs[r] + c], **tol,
                        err_msg=f"{tag} vs host reference (p={p}, rank {r})")
                    assert (out[r][c:] == 0).all(), \
                        f"{tag}: rows past counts[{r}] must be zero"
                n_cases += 1
        # Allreduce (RS + non-uniform allgather) on the default schedule:
        # the replicated full vector, bitwise across ranks.
        comm = LocalComm(p)
        ar = [_host(o) for o in C.allreduce(xs, comm,
                                            spec=CollectiveSpec(counts=counts))]
        q = schedule_rounds(p, "halving")
        ar_bytes = (sum(nonuniform_round_widths(counts))
                    + sum(nonuniform_round_widths(counts, phase="ag"))) * 4 * p
        assert (comm.exchanges, comm.bytes) == (2 * q, ar_bytes), \
            (f"counts[{name}] allreduce p={p}: {comm.exchanges} exchanges, "
             f"{comm.bytes} bytes; want {2 * q}, {ar_bytes}")
        for r in range(p):
            np.testing.assert_allclose(
                ar[r].astype(np.float64), ref["add"], rtol=2e-5, atol=2e-5,
                err_msg=f"counts[{name}] allreduce (p={p})")
            np.testing.assert_array_equal(ar[r], ar[0])
        rounds[name] = (q, comm.exchanges)
        n_cases += 1
        if verbose:
            print(f"ok: counts[{name}] p={p} (sum={N}, bmax={bmax})")
    return {"n_cases": n_cases, "rounds": rounds}


# ---------------------------------------------------------------------------
# Alltoall(v) — uniform + ragged per-pair counts vs simulator + host ref
# ---------------------------------------------------------------------------

def alltoallv_counts_cases(p: int) -> dict[str, tuple[tuple[int, ...], ...]]:
    """Per-pair counts matrices for the ragged alltoallv sweep.

    ``ragged`` mixes sizes; ``zero_pairs`` has whole zero-count rows in
    the round tables (every other (src, dst) pair empty, incl. a rank
    that sends nothing); ``one_rank`` concentrates every payload on a
    single destination (the worst windowed sum — each round one rank's
    wire carries a full vector); ``uniform`` must agree with the dense
    alltoall layout.
    """
    ragged = tuple(tuple((i * 3 + j * 5 + 1) % 4 for j in range(p))
                   for i in range(p))
    zero = tuple(tuple(0 if (i + j) % 2 or i == 0 else i + j + 1
                       for j in range(p)) for i in range(p))
    one = [[0] * p for _ in range(p)]
    for i in range(p):
        one[i][p // 2] = i + 1
    return {
        "ragged": ragged,
        "zero_pairs": zero,
        "one_rank": tuple(tuple(r) for r in one),
        "uniform": tuple((BLK,) * p for _ in range(p)),
    }


def _a2a_input(case_dtype: str, shape, rng: np.random.Generator
               ) -> np.ndarray:
    if case_dtype == "int32":
        return rng.integers(-50, 50, size=shape).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if case_dtype == "bfloat16":
        x = _bf16_exact(x)
    return x


def run_alltoall(p: int, device="cuda", verbose: bool = False) -> dict:
    """Alltoall(v) conformance at axis size p.

    Uniform: circulant alltoall across schedules × dtypes × fused, each
    bitwise against the simulator and the host transpose reference (no
    arithmetic happens, so exactness holds for every dtype), fused ==
    eager bitwise.  Ragged: every ``alltoallv_counts_cases`` matrix
    across schedules, f32 + i32, vs ``simulate_alltoallv`` + host ref,
    zero rows past each rank's receive total.  Both forms take exactly
    ``rounds(schedule)`` exchanges; the ragged one ships
    ``alltoallv_round_widths`` rows per round and rank.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(905 + p)
    n_cases = 0
    rounds: dict[str, tuple[int, ...]] = {}
    for dtype in A2A_DTYPES:
        xg = _a2a_input(dtype, (p, p, BLK), rng)
        inputs = [[xg[r, i] for i in range(p)] for r in range(p)]
        ref = sim.ref_alltoall(inputs)
        W, stats = sim.simulate_alltoall(inputs)
        assert stats.rounds == ceil_log2(p)
        xs = _to_ranks(xg, _TORCH_DTYPES[dtype], device)
        for sched in A2A_SCHEDULES:
            want = schedule_rounds(p, sched)
            outs = {}
            for fused in (False, True):
                comm = LocalComm(p)
                s = CollectiveSpec(schedule=sched, use_fused_kernel=fused)
                out = np.stack([_host(o) for o in C.alltoall(xs, comm,
                                                             spec=s)])
                tag = f"alltoall[{sched}:{dtype}{':fused' if fused else ''}]"
                assert comm.exchanges == want, \
                    f"{tag} p={p}: {comm.exchanges} exchanges, want {want}"
                for r in range(p):
                    for j in range(p):
                        np.testing.assert_array_equal(
                            out[r, j], W[r][j],
                            err_msg=f"{tag} vs simulator (p={p}, rank {r})")
                        np.testing.assert_array_equal(
                            out[r, j], ref[r][j],
                            err_msg=f"{tag} vs host ref (p={p})")
                outs[fused] = out
                n_cases += 1
            assert _same_bits(outs[True], outs[False]), \
                f"alltoall[{sched}:{dtype}] fused != eager (p={p})"
            rounds[f"uniform:{sched}:{dtype}"] = (want,)

    for name, counts in alltoallv_counts_cases(p).items():
        send_tot = [sum(row) for row in counts]
        recv_tot = [sum(counts[s][d] for s in range(p)) for d in range(p)]
        in_h = max(max(send_tot), 1)
        for dtype in ("float32", "int32"):
            inputs = [[_a2a_input(dtype, (counts[r][d], 2), rng)
                       for d in range(p)] for r in range(p)]
            xg = np.zeros((p, in_h, 2),
                          np.int32 if dtype == "int32" else np.float32)
            for r in range(p):
                j = 0
                for d in range(p):
                    c = counts[r][d]
                    xg[r, j:j + c] = inputs[r][d]
                    j += c
            W, stats = sim.simulate_alltoallv(inputs)
            ref = sim.ref_alltoall(inputs)
            xs = _to_ranks(xg, _TORCH_DTYPES[dtype], device)
            for sched in A2A_SCHEDULES:
                tag = f"alltoallv[{name}:{sched}:{dtype}]"
                comm = LocalComm(p)
                out = np.stack([_host(o) for o in C.alltoall(
                    xs, comm, spec=CollectiveSpec(schedule=sched,
                                                  counts=counts))])
                want = schedule_rounds(p, sched)
                widths = alltoallv_round_widths(counts, sched)
                assert comm.exchanges == want, \
                    f"{tag} p={p}: {comm.exchanges} exchanges, want {want}"
                assert comm.bytes == sum(widths) * 2 * 4 * p, \
                    f"{tag} p={p}: {comm.bytes} bytes, widths {widths}"
                for r in range(p):
                    j = 0
                    for s_ in range(p):
                        c = counts[s_][r]
                        np.testing.assert_array_equal(
                            out[r, j:j + c], W[r][s_],
                            err_msg=f"{tag} vs simulator (p={p}, rank {r})")
                        np.testing.assert_array_equal(
                            out[r, j:j + c], ref[r][s_],
                            err_msg=f"{tag} vs host ref (p={p}, rank {r})")
                        j += c
                    assert j == recv_tot[r]
                    assert (out[r, j:] == 0).all(), \
                        f"{tag}: rows past recv total must be zero (p={p})"
                rounds[f"{name}:{sched}:{dtype}"] = (want,)
                n_cases += 1
        if verbose:
            print(f"ok: alltoallv[{name}] p={p} "
                  f"(total={sum(send_tot)} rows)")
    if verbose:
        print(f"ok: alltoall sweep p={p} ({n_cases} cases)")
    return {"n_cases": n_cases, "rounds": rounds}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_sweep(p: int, device="cuda", verbose: bool = False) -> dict:
    """Full conformance sweep at axis size p on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1234 + p)
    cases = sweep_cases(p)
    for case in cases:
        run_case(p, case, rng, dev)
        if verbose:
            print(f"ok: {case.label}")
    rounds = check_round_counts(p, dev)
    if verbose:
        for tag, (n_rs, n_ar, b_rs, b_ar) in rounds.items():
            print(f"ok: rounds p={p} {tag}: RS={n_rs} AR={n_ar} exchanges, "
                  f"{b_rs} / {b_ar} bytes (ceil_log2={ceil_log2(p)})")
    nonuni = run_nonuniform(p, dev, verbose=verbose)
    a2a = run_alltoall(p, dev, verbose=verbose)
    return {"p": p, "n_cases": len(cases), "rounds": rounds,
            "nonuniform": nonuni, "alltoall": a2a}


def main(argv=None) -> int:
    """CLI: run the conformance matrix at ``p`` ranks (default 8); exit 0
    iff every case passes."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.conformance",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("p", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"conformance: {e}", file=sys.stderr)
        return 2
    report = run_sweep(args.p, device=args.device, verbose=True)
    print(f"CONFORMANCE OK (p={args.p}, {report['n_cases']} cases, "
          f"{len(report['rounds'])} schedules, "
          f"{report['nonuniform']['n_cases']} non-uniform cases, "
          f"{report['alltoall']['n_cases']} alltoall cases, "
          f"device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
