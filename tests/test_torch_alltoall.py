"""The port's alltoall(v) and ``permute_rows`` against the reference's.

Pure-Python geometry (``alltoall_moves``, ``a2a_round_entries``,
``alltoallv_round_widths``, the alltoall simulator and the alltoallv row
tables) must equal the JAX package's exactly, for the five schedules and
every p <= 64 (the reference's simulator takes no ``group``, so it is
compared on the four schedules that need none).

``permute_rows``'s plain version must be bitwise the reference's Pallas
kernel in interpret mode and its ``permute_rows_ref``.

Execution: the same seeded payloads go through the reference's plans
under ``repro.compat.shard_map`` on fake CPU devices (one subprocess
worker, ``_torch_alltoall_ref.py``: jnp and fused-interpret uniform
alltoall, and the ragged alltoallv) and through the port's plans on a
``LocalComm``, eager and fused (the fused backend runs ``permute_rows``'s
plain version on the CPU).  Alltoall moves payloads without arithmetic,
so results must be BITWISE equal, with ``ceil_log2(p)`` exchanges each.
A gloo ``DistComm`` world of 3 processes must agree with ``LocalComm``.
"""
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CollectiveSpec as RefSpec
from repro.core import cost_model as ref_cost
from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_sim
from repro.core.plan import plan as ref_plan
from repro.kernels import ref as jax_ref
from repro.kernels.fused_round import permute_rows as jax_permute_rows
from repro_torch.comm import LocalComm, LocalMesh
from repro_torch.core import (CollectiveSpec, alltoall, ceil_log2,
                              circulant_alltoall, circulant_alltoallv, plan)
from repro_torch.core import cost_model, schedule, simulator
from repro_torch.core.plan import final_slot_order
from repro_torch.kernels import permute_rows
from repro_torch.kernels import ref as kernel_ref

HERE = os.path.dirname(os.path.abspath(__file__))
PS = (2, 3, 4, 5, 8)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
BLKS, COLS = (1, 3), 2
SCHEDULES = ("halving", "power2", "fully_connected", "sqrt")


def _schedule_args(p):
    """(schedule, group) pairs of the five schedules at p."""
    return [(s, None) for s in SCHEDULES] + [
        ("two_level", g) for g in range(1, p + 1) if p % g == 0]


def _or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return type(e)


def _ragged_counts(p):
    """Counts with zero-count pairs (the reference's own pattern) and, as
    a second case, a rank that sends nothing."""
    a = tuple(tuple((i * 3 + j * 5) % 4 for j in range(p)) for i in range(p))
    b = tuple(tuple(0 if i == 0 else (i + 2 * j) % 3 + (j == 1)
                    for j in range(p)) for i in range(p))
    return {"mod": a, "silent": b}


def _payload(rng, shape, dt):
    if dt == "int32":
        return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64
                            ).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if dt == "bfloat16":  # bf16-exact values
        x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return x


def _inputs():
    rng = np.random.default_rng(413)
    out = {}
    for p in PS:
        for dt in DTYPES:
            for blk in BLKS:
                out[f"u_{p}_{dt}_{blk}"] = _payload(rng, (p, p, blk, COLS), dt)
        for name, counts in _ragged_counts(p).items():
            in_h = max(max(sum(r) for r in counts), 1)
            x = np.zeros((p, in_h, 3), np.float32)
            for r in range(p):
                n = sum(counts[r])
                x[r, :n] = rng.standard_normal((n, 3))
            out[f"v_{p}_{name}"] = x
            out[f"c_{p}_{name}"] = np.asarray(counts, np.int32)
    return out


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the JAX worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("alltoall")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_alltoall_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return inputs, dict(np.load(d / "out.npz"))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bits_equal(got: torch.Tensor, want: np.ndarray, what: str):
    g = _np(got)
    assert g.shape == want.shape, (what, g.shape, want.shape)
    np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def test_alltoall_moves_and_round_entries_match_reference():
    for p in range(1, 65):
        for sched, g in _schedule_args(p):
            got = _or_error(schedule.alltoall_moves, p, sched, g)
            assert got == _or_error(ref_schedule.alltoall_moves, p, sched,
                                    g), (p, sched, g)
            if not isinstance(got, type):
                assert cost_model.a2a_round_entries(p, sched, g) == \
                    ref_cost.a2a_round_entries(p, sched, g)


@pytest.mark.parametrize("schedule_name", SCHEDULES + ("two_level",))
def test_alltoallv_round_widths_match_reference(schedule_name):
    rng = np.random.default_rng(7)
    for p in range(1, 65):
        group = max(g for g in range(1, p + 1) if p % g == 0 and g * g <= p) \
            if schedule_name == "two_level" else None
        counts = tuple(tuple(int(c) for c in row)
                       for row in rng.integers(0, 4, (p, p)))
        got = _or_error(cost_model.alltoallv_round_widths, counts,
                        schedule_name, group)
        assert got == _or_error(ref_cost.alltoallv_round_widths, counts,
                                schedule_name, group), (p, schedule_name)


@pytest.mark.parametrize("schedule_name", SCHEDULES)
def test_simulator_matches_reference(schedule_name):
    rng = np.random.default_rng(11)
    for p in range(1, 65):
        inputs = [[rng.standard_normal((int(rng.integers(0, 3)), 2))
                   for _ in range(p)] for _ in range(p)]
        for port_fn, ref_fn in ((simulator.simulate_alltoall,
                                 ref_sim.simulate_alltoall),
                                (simulator.simulate_alltoallv,
                                 ref_sim.simulate_alltoallv)):
            out, st = port_fn(inputs, schedule_name)
            want, wst = ref_fn(inputs, schedule_name)
            assert (st.rounds, st.blocks_sent, st.blocks_recv,
                    st.reductions) == (wst.rounds, wst.blocks_sent,
                                       wst.blocks_recv, wst.reductions)
            truth = simulator.ref_alltoall(inputs)
            ref_truth = ref_sim.ref_alltoall(inputs)
            for got in (out, truth):
                for other in (want, ref_truth):
                    assert all(np.array_equal(a, b) for ra, rb in
                               zip(got, other) for a, b in zip(ra, rb)), p


@pytest.mark.parametrize("p", PS + (1, 6, 7, 16))
def test_a2a_plan_tables_match_reference(p):
    cases = dict(_ragged_counts(p), uniform=tuple(
        tuple(2 for _ in range(p)) for _ in range(p)))
    for name, counts in cases.items():
        if not any(map(any, counts)):
            continue
        got = plan(CollectiveSpec(counts=counts), p=p).a2a
        want = ref_plan(RefSpec(counts=counts), p=p, axis_name="x").a2a
        for field in ("counts", "total", "send_total", "recv_total",
                      "in_height", "out_height", "round_widths"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        for field in ("pair_offsets", "seed_src", "seed_dst", "out_rows"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, field)
        assert len(got.round_tables) == len(want.round_tables)
        for a, b in zip(got.round_tables, want.round_tables):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert got.round_widths == cost_model.alltoallv_round_widths(counts)


def test_final_slot_order():
    """The permutation the fused alltoall hands ``permute_rows``: the
    identity at p = 2 and 3 (the main path's ep width), not at 4 or 5."""
    assert final_slot_order(2) == (0, 1)
    assert final_slot_order(3) == (0, 1, 2)
    assert final_slot_order(4) == (0, 3, 1, 2)
    assert final_slot_order(5) == (0, 4, 1, 2, 3)


# ---------------------------------------------------------------------------
# permute_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows,cols", [(1, 1), (2, 1), (3, 7), (4, 130),
                                       (5, 33), (8, 16)])
def test_permute_rows_plain_matches_pallas(dtype, rows, cols):
    rng = np.random.default_rng([rows, cols, len(dtype)])
    x = _payload(rng, (rows, cols), dtype)
    perm = tuple(int(i) for i in rng.permutation(rows))
    got = permute_rows(torch.from_numpy(x).to(DTYPES[dtype]), perm)
    assert got.dtype == DTYPES[dtype]
    jx = jnp.asarray(x, JDT[dtype])
    for name, want in (("interpret", jax_permute_rows(jx, perm,
                                                      interpret=True)),
                       ("ref", jax_ref.permute_rows_ref(jx, perm))):
        _bits_equal(got, np.asarray(want.astype(jnp.float32)
                                    if dtype == "bfloat16" else want),
                    f"{dtype} {rows}x{cols} vs {name}")
    _bits_equal(kernel_ref.permute_rows_ref(
        torch.from_numpy(x).to(DTYPES[dtype]), perm), np.asarray(
            x if dtype != "bfloat16" else x)[list(perm)], "plain")


def test_permute_rows_validates_and_counts_nothing_on_cpu():
    x = torch.arange(12.0).reshape(4, 3)
    before = permute_rows.launches
    for bad in ((0, 1, 2), (0, 1, 2, 2), (0, 1, 2, 4), (1, 2, 3, 4)):
        with pytest.raises(ValueError):
            permute_rows(x, bad)
    with pytest.raises(ValueError):
        permute_rows(x[None], (0,))
    permute_rows(x, (3, 2, 1, 0))
    assert permute_rows.launches == before


def test_permute_rows_backward_is_the_inverse():
    x = torch.randn(5, 4, dtype=torch.float64, requires_grad=True)
    perm = (0, 4, 1, 2, 3)
    w = torch.randn(5, 4, dtype=torch.float64)
    (permute_rows(x, perm) * w).sum().backward()
    inv = [perm.index(i) for i in range(5)]
    assert torch.equal(x.grad, w[inv])
    assert torch.autograd.gradcheck(lambda t: permute_rows(t, perm), (x,))


# ---------------------------------------------------------------------------
# Execution against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("p", PS)
def test_alltoall_bitwise_equal_to_reference(reference, p, fused):
    inputs, want = reference
    q = ceil_log2(p)
    for dt in DTYPES:
        for blk in BLKS:
            key = f"u_{p}_{dt}_{blk}"
            xs = [torch.from_numpy(a).to(DTYPES[dt]) for a in inputs[key]]
            comm = LocalComm(p)
            out = circulant_alltoall(xs, comm, use_fused_kernel=fused)
            assert comm.exchanges == q
            for r in range(p):
                for tag in ("jnp", "fused"):
                    _bits_equal(out[r], want[f"{key}_{tag}"][r],
                                f"{key} rank {r} vs {tag}")
                for j in range(p):  # row j = rank j's payload for r
                    assert torch.equal(out[r][j], xs[j][r])


@pytest.mark.parametrize("p", PS)
def test_alltoallv_bitwise_equal_to_reference_and_simulator(reference, p):
    inputs, want = reference
    for name, counts in _ragged_counts(p).items():
        x = inputs[f"v_{p}_{name}"]
        comm = LocalComm(p)
        out = circulant_alltoallv([torch.from_numpy(a) for a in x], comm,
                                  counts)
        assert comm.exchanges == ceil_log2(p)
        per_pair = []
        for r in range(p):
            j, row = 0, []
            for d in range(p):
                row.append(x[r, j:j + counts[r][d]])
                j += counts[r][d]
            per_pair.append(row)
        sim, _ = simulator.simulate_alltoallv(per_pair)
        for r in range(p):
            _bits_equal(out[r], want[f"v_{p}_{name}_v"][r], f"{name} r={r}")
            j = 0
            for s in range(p):
                c = counts[s][r]
                np.testing.assert_array_equal(out[r][j:j + c].numpy(),
                                              sim[r][s])
                j += c
            assert not out[r][j:].any()


def test_alltoall_is_differentiable_with_counted_exchanges():
    """Eager and fused give the same gradients; the backward adds one
    reverse exchange per round (the transpose of each shift)."""
    p = 4
    rng = np.random.default_rng(5)
    x0 = [torch.from_numpy(rng.standard_normal((p, 2, 3))) for _ in range(p)]
    w = [torch.from_numpy(rng.standard_normal((p, 2, 3))) for _ in range(p)]
    grads = {}
    for fused in (False, True):
        xs = [a.clone().requires_grad_(True) for a in x0]
        comm = LocalComm(p)
        out = circulant_alltoall(xs, comm, use_fused_kernel=fused)
        sum((o * c).sum() for o, c in zip(out, w)).backward()
        assert comm.exchanges == 2 * ceil_log2(p)
        grads[fused] = [a.grad for a in xs]
        # alltoall is its own transpose: d/dx_j[r] = w_r[j]
        for j in range(p):
            for r in range(p):
                assert torch.equal(xs[j].grad[r], w[r][j])
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_local_mesh_axes():
    """A 2x3 mesh, data-major: each axis shifts and sums within its own
    groups, counts its own exchanges, and a shift's backward is the
    reverse shift (one more exchange)."""
    mesh = LocalMesh((2, 3))
    data, model = mesh.axis("data"), mesh.axis("model")
    assert data.ranks == (0, 0, 0, 1, 1, 1)
    assert model.ranks == (0, 1, 2, 0, 1, 2)
    xs = [torch.tensor([float(g)], requires_grad=True) for g in range(6)]
    assert [float(x) for x in data.shift(xs, 1)] == [3, 4, 5, 0, 1, 2]
    got = model.shift(xs, 1)
    assert [float(x) for x in got] == [2, 0, 1, 5, 3, 4]
    assert [float(x) for x in model.all_reduce_sum(xs)] == [3] * 3 + [12] * 3
    assert [float(x) for x in data.all_reduce_sum(xs)] == [3, 5, 7] * 2
    sum((g + 1) * y for g, y in enumerate(got)).sum().backward()
    assert [float(x.grad) for x in xs] == [2, 3, 1, 5, 6, 4]
    assert (data.exchanges, model.exchanges) == (1, 2)
    with pytest.raises(ValueError):
        LocalComm(3, stride=2, size=4)


def test_alltoall_refusals_and_cache_key():
    with pytest.raises(NotImplementedError):
        CollectiveSpec(counts=(1, 2))       # flat counts (Corollary 3)
    with pytest.raises(ValueError):
        CollectiveSpec(counts=((1, 2), (3,)))
    with pytest.raises(ValueError):
        CollectiveSpec(counts=((0, 0), (0, 0)))
    with pytest.raises(ValueError):
        plan(CollectiveSpec(counts=((1, 2), (3, 4)), use_fused_kernel=True),
             p=2)
    with pytest.raises(ValueError):
        plan(CollectiveSpec(counts=((1, 2), (3, 4)), wire_dtype="int8"), p=2)
    with pytest.raises(ValueError):
        plan(CollectiveSpec(counts=((1, 2), (3, 4))), p=3)
    xs = [torch.ones(2, 1, 3)] * 2
    with pytest.raises(NotImplementedError):
        plan(CollectiveSpec(wire_dtype="int8"), p=2).alltoall(xs,
                                                              LocalComm(2))
    vplan = plan(CollectiveSpec(counts=((1, 2), (3, 4))), p=2)
    with pytest.raises(ValueError):
        vplan.reduce_scatter(xs, LocalComm(2))
    with pytest.raises(ValueError):
        vplan.alltoall([torch.ones(3, 1)] * 2, LocalComm(2))  # in_height 7
    # the cache key holds the counts matrix by value
    a = plan(CollectiveSpec(counts=[[1, 2], [3, 4]]), p=2)
    assert a is vplan
    assert plan(CollectiveSpec(counts=((1, 2), (3, 5))), p=2) is not vplan
    assert alltoall(xs, LocalComm(2), spec=CollectiveSpec())[0].shape == \
        (2, 1, 3)


def test_alltoall_on_gloo_dist_comm(tmp_path):
    """Three gloo processes, one ``shift`` per round, agree bitwise with
    the in-process world."""
    world = 3
    x = np.random.default_rng(17).standard_normal((world, world, 2, 3)
                                                  ).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_a2a_worker.py"),
         str(r), str(world), str(port), str(tmp_path / "in.npz"),
         str(tmp_path / "out")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    want = circulant_alltoall([torch.from_numpy(a) for a in x],
                              LocalComm(world))
    for r in range(world):
        out = np.load(tmp_path / f"out.{r}.npz")
        assert int(out["exchanges"]) == 2 * ceil_log2(world)
        for f in (0, 1):
            np.testing.assert_array_equal(out[f"fused{f}"], want[r].numpy())
