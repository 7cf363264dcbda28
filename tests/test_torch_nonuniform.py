"""The port's Corollary-3 non-uniform RS / AG / AR against the reference's.

Same inputs (numpy, seeded) through the JAX package's
``CollectiveSpec(counts=...)`` plans under ``repro.compat.shard_map`` on
fake CPU devices (one subprocess worker, ``_torch_nonuniform_ref.py``,
every case of one (p, pattern) in one jitted body) and through the
port's ``nonuniform`` backend on a ``LocalComm``: p ∈ {2, 3, 5, 8} × the
harness's four counts patterns × ``NONUNIFORM_SCHEDULES`` × add/max/min
× float32/int32 (the allgather alone on float32), and on the halving
schedule max/min on float32 with NaNs and bfloat16 add.  The fold order is the schedule's in both, so results
are BITWISE equal (NaN positions included).  Exchanges are
``rounds(schedule)`` per RS or AG and twice that per AR, and
``comm.bytes`` is ``nonuniform_round_widths`` rows of every rank per
round.  The row tables equal the reference's ``window_rows``; the
refusals (wire, fused, callable op, wrong length, zero-sum, the round
protocol) raise as the reference's do.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.comm import LocalComm
from repro_torch.core import BlockLayout, CollectiveSpec, plan
from repro_torch.core.conformance import (NONUNIFORM_SCHEDULES,
                                          nonuniform_counts_cases,
                                          schedule_rounds)
from repro_torch.core.cost_model import nonuniform_round_widths

HERE = os.path.dirname(os.path.abspath(__file__))
PS = (2, 3, 5, 8)
PATTERNS = ("ragged", "one_column", "zero_ranks", "uniform")
COLS = 3
DTYPES = {"f32": torch.float32, "i32": torch.int32, "nan": torch.float32,
          "bf16": torch.bfloat16}

sys.path.insert(0, HERE)
from _torch_nonuniform_ref import case_names  # noqa: E402


def _inputs():
    rng = np.random.default_rng(315)
    out = {}
    for p in PS:
        for name, counts in nonuniform_counts_cases(p).items():
            shape = (p, sum(counts), COLS)
            key = f"{p}_{name}"
            out[f"{key}_counts"] = np.asarray(counts)
            out[f"{key}_f32"] = rng.standard_normal(shape).astype(np.float32)
            out[f"{key}_i32"] = rng.integers(-1000, 1000, shape).astype(
                np.int32)
            nan = rng.standard_normal(shape).astype(np.float32)
            nan[rng.random(shape) < 0.2] = np.nan
            out[f"{key}_nan"] = nan
            out[f"{key}_bf16"] = (
                rng.standard_normal(shape).astype(np.float32).view(np.uint32)
                & np.uint32(0xFFFF0000)).view(np.float32)  # bf16-exact
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("nonuniform")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the JAX worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_nonuniform_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")], capture_output=True,
        text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return inputs, dict(np.load(d / "out.npz"))


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Bitwise, NaN-aware: NaN where the reference has NaN, the same bits
    elsewhere."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype == np.float32:
        nan = np.isnan(want)
        return bool((np.isnan(got) == nan).all()
                    and (got[~nan].view(np.uint32)
                         == want[~nan].view(np.uint32)).all())
    return bool((got == want).all())


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("p", PS)
def test_bitwise_equal_to_reference(reference, p, pattern):
    inputs, want = reference
    key = f"{p}_{pattern}"
    counts = tuple(int(c) for c in inputs[f"{key}_counts"])
    bmax, row_bytes = max(counts), {k: COLS * (2 if k == "bf16" else 4)
                                    for k in DTYPES}
    xs = {k: [torch.from_numpy(a).to(dt) for a in inputs[f"{key}_{k}"]]
          for k, dt in DTYPES.items()}
    for name, kind, coll, sched, op in case_names():
        comm = LocalComm(p)
        pl = plan(CollectiveSpec(schedule=sched, op=op, counts=counts), p=p)
        assert pl.backend == "nonuniform"
        rs_w = nonuniform_round_widths(counts, sched)
        ag_w = nonuniform_round_widths(counts, sched, phase="ag")
        q = schedule_rounds(p, sched)
        if coll == "rs":
            got = pl.reduce_scatter(xs[kind], comm)
            n, rows = q, sum(rs_w)
        elif coll == "ar":
            got = pl.allreduce(xs[kind], comm)
            n, rows = 2 * q, sum(rs_w) + sum(ag_w)
            for g in got[1:]:
                assert _same(_host(g), _host(got[0])), \
                    f"{key} {name}: AR not replicated bitwise"
        else:
            got = pl.allgather([x[:bmax] for x in xs[kind]], comm)
            n, rows = q, sum(ag_w)
        assert comm.exchanges == n, (key, name, comm.exchanges)
        assert comm.bytes == rows * row_bytes[kind] * p, (key, name)
        for r in range(p):
            assert _same(_host(got[r]), want[f"{key}_{name}"][r]), \
                f"{key} {name} rank {r}"
        if coll == "rs":
            for r in range(p):
                assert (got[r][counts[r]:] == 0).all()


@pytest.mark.parametrize("schedule", NONUNIFORM_SCHEDULES + ("sqrt",))
def test_row_tables_match_reference(schedule):
    """``window_rows`` tables, layout geometry and table widths equal
    the reference's ``BlockLayout`` and ``nonuniform_round_widths``."""
    from repro.core import CollectiveSpec as RefSpec
    from repro.core import plan as ref_plan
    from repro.core.cost_model import \
        nonuniform_round_widths as ref_widths
    rng = np.random.default_rng(7)
    for p in range(2, 17):
        pats = list(nonuniform_counts_cases(p).values())
        pats.append(tuple(int(c) for c in rng.integers(0, 5, p)))
        for counts in pats:
            if sum(counts) == 0:
                continue
            mine = plan(CollectiveSpec(schedule=schedule, counts=counts), p=p)
            ref = ref_plan(RefSpec(schedule=schedule, counts=counts), p=p,
                           axis_name="x")
            assert mine.layout.counts == ref.layout.counts
            assert mine.layout.offsets == ref.layout.offsets
            for a, b in zip(mine.rs_row_tables + mine.ag_row_tables,
                            ref.rs_row_tables + ref.ag_row_tables):
                np.testing.assert_array_equal(a, b)
            for phase in ("rs", "ag"):
                w = nonuniform_round_widths(counts, schedule, phase=phase)
                assert w == ref_widths(counts, schedule, phase=phase)
                tabs = mine.rs_row_tables if phase == "rs" \
                    else mine.ag_row_tables
                assert tuple(t.shape[1] for t in tabs) == w


def test_counts_patterns_match_reference():
    from repro.core.conformance import \
        nonuniform_counts_cases as ref_cases
    for p in (1, 2, 3, 5, 8, 12, 16):
        assert nonuniform_counts_cases(p) == ref_cases(p)


def test_uniform_layout_is_the_uniform_path():
    """``BlockLayout.uniform`` is the uniform blocks' geometry, and equal
    counts through the non-uniform backend give the uniform path's bits."""
    lay = BlockLayout.uniform(3, 7)
    assert lay.counts == (3, 3, 3) and lay.total == 9 and lay.is_uniform
    assert lay.offsets == (0, 3, 6, 9) and lay.bmax == 3
    assert lay.as_blocks(torch.ones(9, 2)).shape == (3, 3, 2)
    with pytest.raises(ValueError):
        lay.as_blocks(torch.ones(7, 2))
    with pytest.raises(ValueError):
        BlockLayout((1, 2)).as_blocks(torch.ones(3))
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((12, 2)).astype(np.float32))
          for _ in range(4)]
    for op in ("add", "max"):
        uni = plan(CollectiveSpec(op=op, use_fused_kernel=False), p=4)
        nonu = plan(CollectiveSpec(op=op, counts=(3,) * 4), p=4)
        for a, b in zip(uni.reduce_scatter(xs, LocalComm(4)),
                        nonu.reduce_scatter(xs, LocalComm(4))):
            assert torch.equal(a, b)
        for a, b in zip(uni.allreduce(xs, LocalComm(4)),
                        nonu.allreduce(xs, LocalComm(4))):
            assert torch.equal(a, b)


def test_p1_returns_input_and_auto_never_fuses():
    x = torch.arange(6.0).reshape(3, 2)
    pl = plan(CollectiveSpec(counts=(3,)), p=1)
    assert pl.reduce_scatter([x], LocalComm(1))[0] is x
    assert pl.allgather([x], LocalComm(1))[0] is x
    pl = plan(CollectiveSpec(counts=(1, 2)), p=2)
    assert pl.backend_for("cuda") == "nonuniform"
    assert pl.backend_for("cpu") == "nonuniform"
    spec = CollectiveSpec(counts=[np.int64(1), 2])
    assert spec.counts == (1, 2) and hash(spec) == hash(
        CollectiveSpec(counts=(1, 2)))
    assert not spec.counts_matrix
    assert CollectiveSpec(counts=((1, 2), (3, 4))).counts_matrix
    assert CollectiveSpec(counts=(1, 2)).label == "circulant:halving:add:counts=2"


@pytest.mark.parametrize("kw", [
    dict(spec=dict(counts=(1, 2), wire_dtype="int8"), p=2),
    dict(spec=dict(counts=(1, 2), use_fused_kernel=True), p=2),
    dict(spec=dict(counts=(1, 2), op="callable"), p=2),
    dict(spec=dict(counts=(1, 2)), p=3),
    dict(spec=dict(counts=(0, 0)), p=2),
    dict(spec=dict(counts=(1, -1)), p=2),
])
def test_refusals_match_reference(kw):
    from repro.core import CollectiveSpec as RefSpec
    from repro.core import plan as ref_plan
    spec = dict(kw["spec"])
    if spec.get("op") == "callable":
        spec["op"] = lambda a, b: a + b
    with pytest.raises(ValueError):
        ref_plan(RefSpec(**spec), p=kw["p"], axis_name="x")
    with pytest.raises(ValueError):
        plan(CollectiveSpec(**spec), p=kw["p"])


def test_round_protocol_refuses_nonuniform():
    from repro.core import CollectiveSpec as RefSpec
    from repro.core import plan as ref_plan
    import jax.numpy as jnp
    ref = ref_plan(RefSpec(counts=(1, 2)), p=2, axis_name="x")
    with pytest.raises(NotImplementedError):
        ref.rs_begin(jnp.ones(3))
    pl = plan(CollectiveSpec(counts=(1, 2)), p=2)
    xs = [torch.ones(3, 2)] * 2
    with pytest.raises(NotImplementedError):
        pl.rs_begin(xs, LocalComm(2))
    with pytest.raises(NotImplementedError):
        pl.ag_begin([torch.ones(2, 2)] * 2, LocalComm(2))
    with pytest.raises(ValueError):
        pl.reduce_scatter([torch.ones(4, 2)] * 2, LocalComm(2))  # 3 rows
    with pytest.raises(ValueError):
        pl.allgather([torch.ones(3, 2)] * 2, LocalComm(2))       # bmax 2
    with pytest.raises(NotImplementedError):
        pl.alltoall(xs, LocalComm(2))
