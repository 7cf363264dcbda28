"""The port's circulant RS / AG / AR against the reference's.

Same inputs (numpy, seeded) through the JAX package's plans under
``repro.compat.shard_map`` on fake CPU devices (one subprocess worker,
``_torch_collectives_ref.py``, for every case) and through the port's
plans on a ``LocalComm``, eager and fused (on the CPU the fused backend
runs ``fused_round``'s plain version).  The fold order is the schedule's
in both, so results must be BITWISE equal: no tolerance.  Round counts
are the reference's HLO collective-permute counts: ``ceil_log2(p)``
exchanges per reduce-scatter or allgather and twice that per allreduce.
A gloo ``DistComm`` world of 3 processes must agree with ``LocalComm``.

On the int8 wire (float32 payloads, quantization group 4, so the
10-element blocks are padded to 12 columns) the max/min results are
bitwise the reference's ``jnp+int8`` plan too, and ``comm.bytes`` counts
``cols + 4 * ceil(cols / g)`` bytes per row sent.  The add fold differs:
the reference plan runs under ``jax.jit``, and XLA's CPU backend
contracts the round's ``live + q * s`` into one FMA where the port rounds
the product and the sum apart (as its CUDA kernel does), so the port's
add results lie within ``2**-21 * max|want|`` of the reference's
(observed: 1 ulp; a requantized code that moved a step would exceed it).
With that expression contracted as XLA contracts it
(``_torch_xla_fma``), the port's wire path is bitwise the reference's
for every op.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_xla_fma as XF
from repro_torch.comm import LocalComm
from repro_torch.core import (CollectiveSpec, allgather, ceil_log2, plan,
                              reduce_scatter)
from repro_torch.core import collectives as C
from repro_torch.core.conformance import nonuniform_counts_cases
from repro_torch.core.cost_model import nonuniform_round_widths
from repro_torch.kernels import ref as kernel_ref
from repro_torch.kernels.quantize import wire_width

HERE = os.path.dirname(os.path.abspath(__file__))
PS = (2, 3, 4, 5, 8)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
OPS = ("add", "max", "min")
BLK, COLS = 2, 5
WIRE_GROUP = 4  # = _torch_collectives_ref.WIRE_GROUP


def _inputs():
    rng = np.random.default_rng(2024)
    out = {}
    for p in PS:
        for dt in DTYPES:
            shape = (p, p * BLK, COLS)
            if dt == "int32":
                x = rng.integers(-1000, 1000, shape).astype(np.int32)
            else:
                x = rng.standard_normal(shape).astype(np.float32)
                if dt == "bfloat16":  # bf16-exact values
                    x = (x.view(np.uint32) & np.uint32(0xFFFF0000)
                         ).view(np.float32)
            out[f"{p}_{dt}"] = x
    return out


def _run(cmd, **kw):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the JAX worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    proc = _run([sys.executable, os.path.join(HERE, "_torch_collectives_ref.py"),
                 str(d / "in.npz"), str(d / "out.npz")])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return inputs, dict(np.load(d / "out.npz"))


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return a.view(np.uint32)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", PS)
def test_bitwise_equal_to_reference(reference, p, dtype, fused):
    inputs, want = reference
    key = f"{p}_{dtype}"
    xs = [torch.from_numpy(a).to(DTYPES[dtype]) for a in inputs[key]]
    q = ceil_log2(p)
    for op in OPS:
        comm = LocalComm(p)
        pl = plan(CollectiveSpec(op=op, use_fused_kernel=fused), p=p)
        rs = pl.reduce_scatter(xs, comm)
        assert comm.exchanges == q
        ar = pl.allreduce(xs, comm)
        assert comm.exchanges == q + 2 * q
        for r in range(p):
            for name, got in (("rs", rs[r]), ("ar", ar[r])):
                np.testing.assert_array_equal(
                    _bits(got), want[f"{key}_{name}_{op}"][r].view(np.uint32),
                    err_msg=f"{key} {name} {op} rank {r} fused={fused}")
    comm = LocalComm(p)
    ag = allgather([x[:BLK] for x in xs], comm,
                   spec=CollectiveSpec(use_fused_kernel=fused))
    assert comm.exchanges == q
    for r in range(p):
        np.testing.assert_array_equal(_bits(ag[r]),
                                      want[f"{key}_ag"][r].view(np.uint32))


def test_fused_equals_eager_across_schedules():
    """Every Corollary-2 schedule, fused and eager agree bitwise."""
    rng = np.random.default_rng(5)
    for p in (6, 7):
        xs = [torch.from_numpy(rng.standard_normal((p * 3, 4)).astype(
            np.float32)) for _ in range(p)]
        for schedule in ("halving", "power2", "fully_connected", "sqrt"):
            outs = [C.circulant_allreduce(xs, LocalComm(p), schedule=schedule,
                                          use_fused_kernel=f)
                    for f in (False, True)]
            for a, b in zip(*outs):
                assert torch.equal(a, b), schedule


def test_round_protocol_guards():
    comm = LocalComm(3)
    pl = plan(CollectiveSpec(), p=3)
    st = pl.rs_begin([torch.ones(3, 2)] * 3, comm)
    with pytest.raises(ValueError):
        pl.finish_round(st)  # nothing in flight
    pl.start_round(st)
    with pytest.raises(ValueError):
        pl.start_round(st)   # already started
    with pytest.raises(ValueError):
        pl.rs_end(st)        # unfinished
    with pytest.raises(ValueError):
        pl.reduce_scatter([torch.ones(3, 2)] * 3, LocalComm(4))  # wrong p


@pytest.mark.parametrize("kw", [dict(kind="ring"), dict(kind="broadcast"),
                                dict(kind="xla"),
                                dict(kind="recursive_halving")])
def test_unported_spec_fields_raise(kw):
    """Every kind plans as the reference's does: the same backend, the
    same label, the collectives that backend implements (``BACKENDS``),
    and ``counts=`` refused for any kind but circulant.  (These kinds
    raised ``NotImplementedError`` before they were ported; the
    refusals of unknown kinds and of callables on the kernel stay.)"""
    from repro.core import CollectiveSpec as RefSpec
    from repro.core import plan as ref_plan
    from repro.core.plan import BACKENDS as REF_BACKENDS
    from repro_torch.core.plan import BACKENDS
    spec, ref = CollectiveSpec(**kw), RefSpec(**kw)
    assert spec.label == ref.label
    for p in (4, 5):
        mine = plan(spec, p=p)
        theirs = ref_plan(ref, p=p, axis_name="x")
        assert mine.backend == theirs.backend
        assert BACKENDS[mine.backend] == REF_BACKENDS[theirs.backend]
        assert mine.skips == theirs.skips
        assert mine.ag_send_blocks == theirs.ag_send_blocks
    with pytest.raises(ValueError, match="needs kind='circulant'"):
        CollectiveSpec(counts=(1, 2, 3, 4), **kw)
    with pytest.raises(ValueError):
        CollectiveSpec(kind="nope")
    with pytest.raises(ValueError):
        plan(CollectiveSpec(op=lambda a, b: a + b, use_fused_kernel=True), p=3)


def _wire_run(xs, p, op, fused):
    comm = LocalComm(p)
    pl = plan(CollectiveSpec(op=op, use_fused_kernel=fused, wire_dtype="int8",
                             wire_group=WIRE_GROUP), p=p)
    rs = pl.reduce_scatter(xs, comm)
    q = ceil_log2(p)
    padded = -(-BLK * COLS // WIRE_GROUP) * WIRE_GROUP
    row = wire_width(padded, WIRE_GROUP)  # bytes per block row on the wire
    assert comm.exchanges == q
    assert comm.bytes == p * (p - 1) * row   # p - 1 rows sent per rank
    ar = pl.allreduce(xs, comm)
    assert comm.exchanges == 3 * q
    assert comm.bytes == 3 * p * (p - 1) * row
    return rs, ar


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("p", PS)
def test_wire_matches_reference(reference, p, fused, monkeypatch):
    inputs, want = reference
    key = f"{p}_float32"
    xs = [torch.from_numpy(a) for a in inputs[key]]
    for op in OPS:
        rs, ar = _wire_run(xs, p, op, fused)
        for name, got in (("wrs", rs), ("war", ar)):
            w = want[f"{key}_{name}_{op}"]
            g = np.stack([t.numpy() for t in got])
            what = f"{key} {name} {op} fused={fused}"
            if op == "add":
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=2**-21 * np.abs(w).max(),
                                           err_msg=what)
            else:
                np.testing.assert_array_equal(g.view(np.uint32),
                                              w.view(np.uint32), err_msg=what)
    comm = LocalComm(p)
    ag = C.circulant_allgather([x[:BLK] for x in xs], comm,
                               use_fused_kernel=fused, wire_dtype="int8",
                               wire_group=WIRE_GROUP)
    assert comm.exchanges == ceil_log2(p)
    for r in range(p):
        np.testing.assert_array_equal(ag[r].numpy().view(np.uint32),
                                      want[f"{key}_wag"][r].view(np.uint32))
    # The same rounds with the add fold contracted as XLA contracts it.
    monkeypatch.setattr(kernel_ref, "quantize_ref", XF.quantize)
    monkeypatch.setattr(kernel_ref, "fused_round_dq_ref", XF.fused_round_dq)
    for op in OPS:
        rs, ar = _wire_run(xs, p, op, fused)
        for name, got in (("wrs", rs), ("war", ar)):
            np.testing.assert_array_equal(
                np.stack([t.numpy() for t in got]).view(np.uint32),
                want[f"{key}_{name}_{op}"].view(np.uint32),
                err_msg=f"{key} {name} {op} fused={fused} contracted")


def test_wire_fused_equals_eager_and_validates():
    rng = np.random.default_rng(12)
    for p in (6, 7):
        xs = [torch.from_numpy(rng.standard_normal((p * 3, 130)).astype(
            np.float32)) for _ in range(p)]
        for schedule in ("halving", "power2", "fully_connected", "sqrt"):
            outs = [C.circulant_allreduce(xs, LocalComm(p), schedule=schedule,
                                          use_fused_kernel=f,
                                          wire_dtype="int8")
                    for f in (False, True)]
            for a, b in zip(*outs):
                assert torch.equal(a, b), schedule
    assert CollectiveSpec(wire_dtype="int8").wired
    assert not CollectiveSpec().wired
    with pytest.raises(ValueError, match="float payload"):
        plan(CollectiveSpec(wire_dtype="int8"), p=3).reduce_scatter(
            [torch.ones(3, 2, dtype=torch.int32)] * 3, LocalComm(3))
    with pytest.raises(ValueError, match="named op"):
        plan(CollectiveSpec(wire_dtype="int8", op=lambda a, b: a + b), p=3)
    with pytest.raises(ValueError, match="wire_dtype"):
        CollectiveSpec(wire_dtype="fp8")
    with pytest.raises(ValueError, match="bit-exactly"):
        CollectiveSpec(kind="broadcast", wire_dtype="int8")


@pytest.mark.parametrize("schedule", ["halving", "power2", "fully_connected",
                                      "sqrt"])
def test_plan_tables_match_reference(schedule):
    """Per-round send/recv block tables equal the reference plan's
    (Theorem 1's partition of the p-1 non-resident blocks)."""
    from repro.core import CollectiveSpec as RefSpec
    from repro.core import plan as ref_plan
    for p in range(1, 17):
        mine = plan(CollectiveSpec(schedule=schedule), p=p)
        ref = ref_plan(RefSpec(schedule=schedule), p=p, axis_name="x")
        for name in ("skips", "rs_send_blocks", "rs_recv_blocks",
                     "ag_send_blocks", "ag_recv_blocks"):
            assert getattr(mine, name) == getattr(ref, name), (p, name)
        sent = sorted(b for blocks in mine.rs_send_blocks for b in blocks)
        assert sent == list(range(1, p))


def test_plan_cache_identity_and_invalidate():
    s = CollectiveSpec(schedule="power2")
    assert plan(s, p=6) is plan(s, p=6)
    assert plan.invalidate(p=6) >= 1
    assert plan(s, p=6).skips == (4, 2, 1)


def test_dist_comm_gloo_matches_local(tmp_path):
    """Three gloo processes, one ``shift`` per round, agree bitwise with
    the in-process world, uniform and with the harness's ``ragged``
    non-uniform counts."""
    world = 3
    rng = np.random.default_rng(9)
    counts = nonuniform_counts_cases(world)["ragged"]
    inputs = {"f32": rng.standard_normal((world, world * 4, 3)).astype(
        np.float32),
        "i32": rng.integers(-50, 50, (world, world * 4, 3)).astype(np.int32),
        "nu_counts": np.asarray(counts),
        "nu_f32": rng.standard_normal((world, sum(counts), 3)).astype(
            np.float32),
        "nu_i32": rng.integers(-50, 50, (world, sum(counts), 3)).astype(
            np.int32)}
    np.savez(tmp_path / "in.npz", **inputs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
         str(r), str(world), str(port), str(tmp_path / "in.npz"),
         str(tmp_path / "out")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    q = ceil_log2(world)
    for r in range(world):
        # 2 keys x 2 ops x 2 backends x (RS + AR = 3 rounds' worth of q)
        assert int(outs[r]["exchanges"]) == 2 * 2 * 2 * 3 * q
    for r in range(world):
        # 2 keys x 2 ops x (RS + AR = 3 rounds' worth of q), rows of
        # every round's worst window (f32 and i32: 4-byte elements)
        rows = sum(nonuniform_round_widths(counts)) * 2 + sum(
            nonuniform_round_widths(counts, phase="ag"))
        assert int(outs[r]["nu_exchanges"]) == 2 * 2 * 3 * q
        assert int(outs[r]["nu_bytes"]) == 2 * 2 * rows * 3 * 4
    for key in ("nu_f32", "nu_i32"):
        xs = [torch.from_numpy(a) for a in inputs[key]]
        for op in ("add", "max"):
            pl = plan(CollectiveSpec(op=op, counts=counts), p=world)
            rs = pl.reduce_scatter(xs, LocalComm(world))
            ar = pl.allreduce(xs, LocalComm(world))
            for r in range(world):
                np.testing.assert_array_equal(outs[r][f"{key}_{op}_rs"],
                                              rs[r].numpy())
                np.testing.assert_array_equal(outs[r][f"{key}_{op}_ar"],
                                              ar[r].numpy())
    for key, arr in ((k, inputs[k]) for k in ("f32", "i32")):
        xs = [torch.from_numpy(a) for a in arr]
        for op in ("add", "max"):
            for fused in (False, True):
                pl = plan(CollectiveSpec(op=op, use_fused_kernel=fused),
                          p=world)
                rs = reduce_scatter(xs, LocalComm(world), spec=pl.spec)
                ar = pl.allreduce(xs, LocalComm(world))
                tag = f"{key}_{op}_{int(fused)}"
                for r in range(world):
                    np.testing.assert_array_equal(outs[r][f"{tag}_rs"],
                                                  rs[r].numpy())
                    np.testing.assert_array_equal(outs[r][f"{tag}_ar"],
                                                  ar[r].numpy())
