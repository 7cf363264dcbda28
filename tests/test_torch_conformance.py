"""The port's conformance harness (``repro_torch.core.conformance``).

``run_sweep(p, device="cpu")`` at every p of ``DEFAULT_PS``, in process
on a ``LocalComm`` (no fake devices, so no subprocess): the reference's
RS / AR case list (the ring, xla and recursive-halving baselines, and
the circulant schedules × ops × dtypes with fused and int8-wire
mirrors) against the host reference and, for the circulant kind off the
wire for float32 and int32, bitwise against the port's simulator, with
every case's exchanges, native calls and (baselines) bytes; exchange and
byte counts of every schedule; Corollary 3's counts patterns; the
alltoall(v); the broadcast kind; the hierarchical collectives on a
two-axis ``LocalMesh`` (non-prime p).  Then the static coverage checks
of ``tests/test_conformance.py``, the case lists held equal to the
reference's, unfiltered, and the CLI (``--device cpu``; without it, and
without a card, a refusal).
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.conformance import (
    A2A_SCHEDULES, BROADCAST_SCHEDULES, DEFAULT_PS, NONUNIFORM_SCHEDULES, OPS,
    SCHEDULES, Case, _tolerances, alltoallv_counts_cases, case_spec,
    hierarchical_factors, nonuniform_counts_cases, run_broadcast,
    run_hierarchical, run_sweep, sweep_cases, two_level_group)
from repro_torch.core.schedule import ceil_log2

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.mark.parametrize("p", DEFAULT_PS)
def test_conformance_sweep(p):
    report = run_sweep(p, device="cpu")
    assert report["n_cases"] == len(sweep_cases(p))
    assert len(report["rounds"]) == len(SCHEDULES) * 4
    assert report["nonuniform"]["n_cases"] == 4 * (
        len(NONUNIFORM_SCHEDULES) * 2 + 1)
    assert report["alltoall"]["n_cases"] > 0
    assert report["broadcast"]["n_cases"] == len(BROADCAST_SCHEDULES) * 2
    fac = hierarchical_factors(p)
    if fac is None:
        assert report["hierarchical"] is None
    else:
        rounds = ceil_log2(fac[0]) + ceil_log2(fac[1])
        assert report["hierarchical"]["n_cases"] == 12
        assert set(report["hierarchical"]["rounds"].values()) == \
            {(rounds, 2 * rounds)}


@pytest.mark.parametrize("p", DEFAULT_PS)
def test_broadcast_and_hierarchical_match_reference_harness(p):
    """``run_broadcast`` / ``run_hierarchical`` on their own, and what
    they cover: the reference's schedules and mesh factorizations."""
    from repro.core import conformance as R
    assert BROADCAST_SCHEDULES == R.BROADCAST_SCHEDULES
    assert hierarchical_factors(p) == R.hierarchical_factors(p)
    bc = run_broadcast(p, device="cpu")
    assert bc["rounds"]["halving"] == bc["rounds"]["power2"] == ceil_log2(p)
    hier = run_hierarchical(p, device="cpu")
    assert (hier is None) == (R.hierarchical_factors(p) is None)


def test_sweep_covers_required_space():
    """The case list spans every schedule, op and dtype, mirrored on the
    fused kernel and, for float dtypes, on the int8 wire."""
    cases = sweep_cases(8)
    assert {c.impl for c in cases} == {"circulant", "ring", "xla",
                                       "recursive_halving"}
    assert {c.impl for c in sweep_cases(6)} == {"circulant", "ring", "xla"}
    assert {c.schedule for c in cases} == set(SCHEDULES)
    assert {c.op for c in cases} == set(OPS)
    assert {c.dtype for c in cases} == {"float32", "bfloat16", "int32"}
    assert {c.collective for c in cases} == {"reduce_scatter", "allreduce"}
    cases = [c for c in cases if c.impl == "circulant"]
    plain = {(c.collective, c.schedule, c.op, c.dtype) for c in cases
             if not c.fused and c.wire is None}
    fused = {(c.collective, c.schedule, c.op, c.dtype) for c in cases
             if c.fused and c.wire is None}
    assert fused == plain and fused
    for fl in (False, True):
        base = {(c.collective, c.schedule, c.op, c.dtype) for c in cases
                if c.fused is fl and c.wire is None and c.dtype != "int32"}
        wired = {(c.collective, c.schedule, c.op, c.dtype) for c in cases
                 if c.fused is fl and c.wire == "int8"}
        assert wired == base and wired
    assert not any(c.wire for c in cases if c.dtype == "int32")


def test_cases_route_through_collective_spec():
    from repro_torch.core import CollectiveSpec
    for p in (6, 8):
        for c in sweep_cases(p):
            spec = case_spec(c, p)
            assert isinstance(spec, CollectiveSpec)
            assert spec.kind == c.impl
            if c.impl != "circulant":
                assert (spec.op, spec.wire_dtype, spec.use_fused_kernel) \
                    == (c.op, None, None)
                continue
            assert spec.schedule == c.schedule
            assert spec.wire_dtype == c.wire
            assert spec.use_fused_kernel is c.fused
            assert (spec.group is not None) == (c.schedule == "two_level")


def test_cases_equal_reference():
    """The port's case lists, counts patterns and tolerances are the
    reference's, every case of them."""
    from repro.core import conformance as R
    assert (DEFAULT_PS, SCHEDULES, OPS, NONUNIFORM_SCHEDULES,
            A2A_SCHEDULES) == (R.DEFAULT_PS, R.SCHEDULES, R.OPS,
                               R.NONUNIFORM_SCHEDULES, R.A2A_SCHEDULES)
    for p in DEFAULT_PS:
        ref = [dataclasses.astuple(c) for c in R.sweep_cases(p)]
        mine = [dataclasses.astuple(c) for c in sweep_cases(p)]
        assert mine == ref
        assert [c.label for c in sweep_cases(p)] == \
            [c.label for c in R.sweep_cases(p)]
        for c in sweep_cases(p):
            assert _tolerances(c, p) == R._tolerances(R.Case(
                c.collective, c.impl, c.schedule, c.op, c.dtype, c.fused,
                c.wire), p)
        assert nonuniform_counts_cases(p) == R.nonuniform_counts_cases(p)
        assert alltoallv_counts_cases(p) == R.alltoallv_counts_cases(p)
        assert two_level_group(p) == R.two_level_group(p)
    assert Case("allreduce", fused=True, wire="int8").label == \
        "allreduce[circulant:halving:add:float32:fused:wire=int8]"


def test_nonuniform_cases_cover_required_space():
    assert set(NONUNIFORM_SCHEDULES) >= {"halving", "power2"}
    for p in DEFAULT_PS:
        cases = nonuniform_counts_cases(p)
        assert {"ragged", "one_column", "zero_ranks", "uniform"} <= set(cases)
        for counts in cases.values():
            assert len(counts) == p and sum(counts) > 0
        one_col = cases["one_column"]
        assert sorted(one_col, reverse=True)[1:] == [0] * (p - 1)
        assert 0 in cases["zero_ranks"]


def test_alltoallv_cases_cover_required_space():
    assert set(A2A_SCHEDULES) >= {"halving", "power2"}
    for p in DEFAULT_PS:
        cases = alltoallv_counts_cases(p)
        assert {"ragged", "zero_pairs", "one_rank", "uniform"} <= set(cases)
        for counts in cases.values():
            assert len(counts) == p
            assert all(len(row) == p for row in counts)
            assert sum(sum(row) for row in counts) > 0
        one = cases["one_rank"]
        assert all(c == 0 for row in one for j, c in enumerate(row)
                   if j != p // 2)
        zero = cases["zero_pairs"]
        assert any(c == 0 for row in zero for c in row)
        assert any(sum(row) == 0 for row in zero)


def test_default_ps_mostly_non_pow2():
    non_pow2 = [p for p in DEFAULT_PS if p & (p - 1)]
    assert len(non_pow2) >= 4, "non-powers-of-two are the paper's point"


def test_two_level_group_divides():
    for p in DEFAULT_PS:
        g = two_level_group(p)
        assert g >= 1 and p % g == 0
    assert two_level_group(12) == 3
    assert two_level_group(16) == 4
    assert two_level_group(7) == 1


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         env.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-m", "repro_torch.core.conformance",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_cli_on_cpu_and_refusal_without_card():
    proc = _cli("5", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CONFORMANCE OK (p=5, 72 cases" in proc.stdout
    assert "6 broadcast cases, device cpu" in proc.stdout
    proc = _cli("6", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "hierarchical 3x2: 12 cases" in proc.stdout
    if not torch.cuda.is_available():
        proc = _cli("3")
        assert proc.returncode == 2
        assert "CONFORMANCE OK" not in proc.stdout
        assert "--device cpu" in proc.stderr
