"""The paper's baselines, broadcast, hierarchical collectives and the
per-round hooks of the port against the reference's.

Same seeded numpy inputs through the JAX package's plans under
``repro.compat.shard_map`` on fake CPU devices (one subprocess worker,
``_torch_baselines_ref.py``, for every case) and through the port's on a
``LocalComm`` / ``LocalMesh``:

* ring reduce-scatter and allreduce and recursive halving (p ∈ {2, 4,
  8}) at p ∈ {2, 3, 4, 5, 8}, f32 / bf16 / i32 × add / max / min: BITWISE
  (one ⊕ per received block in the payload's dtype, the reference's
  operand order); ring p-1 exchanges per reduce-scatter and 2(p-1) per
  allreduce, recursive halving log2 p, each sending p-1 blocks per rank
  and phase (all volume-optimal); recursive halving refuses p = 3 with
  the reference's message;
* the native (``xla``) reduce-scatter, allreduce and allgather: no
  exchange and one native call each; the sums within the reference's
  conformance tolerances (XLA's CPU fold order is its own; the port folds
  in rank order), int32 and the allgather exactly;
* broadcast at p ∈ {2, 3, 5, 8} × halving / power2: bitwise, replicated,
  ``ceil_log2(p)`` exchanges; the spec's refusals are the reference's;
* hierarchical RS / AG / AR over the reference's ``hierarchical_factors``
  meshes (p ∈ {6, 8, 12}), eager and fused, exact (bitwise) and on the
  int8 wire, with ``ceil_log2`` exchanges per axis and phase;
* the ``compress=`` / ``decompress=`` hooks of ``make_compressors``
  against the reference's ``make_compressors(backend="jnp")``.

On the int8 wire and through the hooks the add fold is not bitwise: the
reference runs under ``jax.jit``, whose CPU backend contracts ``acc + q
* s`` into one FMA where the port rounds the product and the sum apart
(``test_torch_collectives.py``).  Those results are held within
``2**-21 * max|want|`` (one rounding of the largest product, 2**-24 of
it, and an ulp of the result, with margin for the few elements a round
later carries it into), and bitwise once the port's expressions are
contracted as XLA contracts them (``_torch_xla_fma``): the wire by
patching its plain versions, the hooks by a ``decompress`` that keeps
the exact product and a fold that adds it in float64 and rounds once.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_xla_fma as XF
from repro_torch.comm import LocalComm, LocalMesh
from repro_torch.core import CollectiveSpec, ceil_log2, plan
from repro_torch.core import collectives as C
from repro_torch.core.conformance import (Case, _tolerances,
                                          hierarchical_factors)
from repro_torch.kernels import make_compressors, quantize_blocks
from repro_torch.kernels import ref as kernel_ref

HERE = os.path.dirname(os.path.abspath(__file__))
PS = (2, 3, 4, 5, 8)
BC_PS = (2, 3, 5, 8)
HIER_PS = (6, 8, 12)
HOOK_PS = (2, 3, 5, 8)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
OPS = ("add", "max", "min")
SCHEDULES = ("halving", "power2")
BLK, COLS = 2, 3
WIRE_GROUP = 4  # = _torch_baselines_ref.WIRE_GROUP


def _payload(rng, shape, dt):
    if dt == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if dt == "bfloat16":  # bf16-exact values
        x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return x


def _inputs():
    rng = np.random.default_rng(2025)
    out = {}
    for p in PS:
        for dt in DTYPES:
            out[f"{p}_{dt}"] = _payload(rng, (p, p * BLK, COLS), dt)
    for p in BC_PS:
        for dt in ("float32", "int32"):
            out[f"bc_{p}_{dt}"] = _payload(rng, (p, BLK, COLS), dt)
    for p in HIER_PS:
        out[f"g_{p}"] = np.asarray(p // hierarchical_factors(p)[0])
        out[f"hier_{p}"] = _payload(rng, (p, p * BLK, 5), "float32")
        out[f"hierblk_{p}"] = _payload(rng, (p, BLK, 5), "float32")
    for p in HOOK_PS:
        out[f"hook_{p}"] = _payload(rng, (p, p * BLK, 5), "float32")
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("baselines")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the JAX worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_baselines_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return inputs, dict(np.load(d / "out.npz"))


def _ranks(a: np.ndarray, dt: torch.dtype) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dt) for x in a]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_bits(got: list, want: np.ndarray, what: str) -> None:
    g = np.stack([_np(t) for t in got])
    assert g.shape == want.shape, (what, g.shape, want.shape)
    np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32),
                                  err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", PS)
def test_baselines_match_reference(reference, p, dtype):
    inputs, want = reference
    key = f"{p}_{dtype}"
    xs = _ranks(inputs[key], DTYPES[dtype])
    item = xs[0].element_size()
    blk_bytes = BLK * COLS * item
    for op in OPS:
        ring = plan(CollectiveSpec(kind="ring", op=op), p=p)
        comm = LocalComm(p)
        rs = ring.reduce_scatter(xs, comm)
        assert (comm.exchanges, comm.bytes) == \
            (p - 1, p * (p - 1) * blk_bytes)
        _assert_bits(rs, want[f"{key}_ring_rs_{op}"], f"{key} ring rs {op}")
        comm = LocalComm(p)
        ar = ring.allreduce(xs, comm)
        assert (comm.exchanges, comm.bytes) == \
            (2 * (p - 1), 2 * p * (p - 1) * blk_bytes)
        _assert_bits(ar, want[f"{key}_ring_ar_{op}"], f"{key} ring ar {op}")
        if p & (p - 1) == 0:
            comm = LocalComm(p)
            rs = plan(CollectiveSpec(kind="recursive_halving", op=op),
                      p=p).reduce_scatter(xs, comm)
            assert (comm.exchanges, comm.bytes) == \
                (ceil_log2(p), p * (p - 1) * blk_bytes)
            _assert_bits(rs, want[f"{key}_rh_rs_{op}"],
                         f"{key} recursive halving rs {op}")
    xla = plan(CollectiveSpec(kind="xla"), p=p)
    for coll, fn in (("reduce_scatter", xla.reduce_scatter),
                     ("allreduce", xla.allreduce)):
        comm = LocalComm(p)
        got = np.stack([_np(t) for t in fn(xs, comm)])
        assert (comm.exchanges, comm.bytes, comm.natives) == (0, 0, 1)
        w = want[f"{key}_xla_{'rs' if coll == 'reduce_scatter' else 'ar'}"]
        tol = _tolerances(Case(coll, "xla", dtype=dtype), p)
        np.testing.assert_allclose(got.astype(np.float64),
                                   w.astype(np.float64), **tol,
                                   err_msg=f"{key} xla {coll}")
        if coll == "allreduce":
            for r in range(1, p):
                np.testing.assert_array_equal(got[r], got[0])
    comm = LocalComm(p)
    ag = xla.allgather([x[:BLK] for x in xs], comm)
    assert (comm.exchanges, comm.natives) == (0, 1)
    _assert_bits(ag, want[f"{key}_xla_ag"], f"{key} xla ag")


def test_recursive_halving_needs_power_of_two():
    pl = plan(CollectiveSpec(kind="recursive_halving"), p=3)
    with pytest.raises(ValueError,
                       match="recursive halving needs power-of-two p, got 3"):
        pl.reduce_scatter([torch.ones(3, 2)] * 3, LocalComm(3))
    one = plan(CollectiveSpec(kind="recursive_halving"), p=1)
    x = torch.ones(3, 2)
    assert one.reduce_scatter([x], LocalComm(1))[0] is x


@pytest.mark.parametrize("p", BC_PS)
def test_broadcast_matches_reference(reference, p):
    inputs, want = reference
    for dt in ("float32", "int32"):
        key = f"bc_{p}_{dt}"
        xs = _ranks(inputs[key], DTYPES[dt])
        full = inputs[key].reshape(p * BLK, COLS)
        for sched in SCHEDULES:
            comm = LocalComm(p)
            out = C.broadcast(xs, comm, schedule=sched)
            assert comm.exchanges == ceil_log2(p)
            _assert_bits(out, want[f"{key}_{sched}"], f"{key} {sched}")
            for t in out:
                np.testing.assert_array_equal(_np(t), full)


def test_broadcast_spec_refusals_are_the_reference():
    from repro.core import CollectiveSpec as RefSpec
    for kw in (dict(wire_dtype="int8"), dict(use_fused_kernel=True),
               dict(counts=(1, 2, 3))):
        with pytest.raises(ValueError) as mine:
            CollectiveSpec(kind="broadcast", **kw)
        with pytest.raises(ValueError) as ref:
            RefSpec(kind="broadcast", **kw)
        assert str(mine.value) == str(ref.value)
    pl = plan(CollectiveSpec(kind="broadcast"), p=3)
    assert pl.backend == "broadcast"
    xs = [torch.ones(3, 2)] * 3
    for fn in (pl.reduce_scatter, pl.allgather, pl.rs_begin, pl.ag_begin):
        with pytest.raises(NotImplementedError, match="multi-call"):
            fn(xs, LocalComm(3))
    with pytest.raises(ValueError, match="does not implement broadcast"):
        plan(CollectiveSpec(counts=(1, 2, 3)), p=3).broadcast(
            [torch.ones(3)] * 3, LocalComm(3))


def _hier(xs, blocks, a, b, kw):
    axes = ("x", "y")
    out = {}
    for name, fn, inp in (("rs", C.hierarchical_reduce_scatter, xs),
                          ("ar", C.hierarchical_allreduce, xs),
                          ("ag", C.hierarchical_allgather, blocks)):
        mesh = LocalMesh((a, b), axes)
        out[name] = fn(inp, mesh, axes, **kw)
        per_phase = 2 if name == "ar" else 1
        assert (mesh.axis("x").exchanges, mesh.axis("y").exchanges) == \
            (per_phase * ceil_log2(a), per_phase * ceil_log2(b)), name
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("p", HIER_PS)
def test_hierarchical_matches_reference(reference, p, fused, monkeypatch):
    inputs, want = reference
    a, b = hierarchical_factors(p)
    key = f"hier_{p}"
    xs = _ranks(inputs[key], torch.float32)
    blocks = _ranks(inputs[f"hierblk_{p}"], torch.float32)
    exact = _hier(xs, blocks, a, b, dict(use_fused_kernel=fused))
    for name, got in exact.items():
        _assert_bits(got, want[f"{key}_{name}"], f"{key} {name}")
    wire = dict(use_fused_kernel=fused, wire_dtype="int8",
                wire_group=WIRE_GROUP)
    out = _hier(xs, blocks, a, b, wire)
    for name, got in out.items():
        w = want[f"{key}_w{name}"]
        g = np.stack([_np(t) for t in got])
        if name == "ag":  # transport of codes quantized once: bitwise
            np.testing.assert_array_equal(g.view(np.uint32),
                                          w.view(np.uint32))
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2**-21 * np.abs(w).max(),
                                       err_msg=f"{key} wire {name}")
    for t in out["ar"][1:]:  # every rank dequantizes the same codes
        assert torch.equal(t, out["ar"][0])
    monkeypatch.setattr(kernel_ref, "quantize_ref", XF.quantize)
    monkeypatch.setattr(kernel_ref, "fused_round_dq_ref", XF.fused_round_dq)
    for name, got in _hier(xs, blocks, a, b, wire).items():
        _assert_bits(got, want[f"{key}_w{name}"], f"{key} wire {name} "
                     f"contracted")


def _contracted_compressors(group):
    """``make_compressors`` with XLA's contraction: ``decompress`` keeps
    the exact product ``q * s`` (float64) for :func:`_fma_add`."""
    metas = []

    def compress(x):
        payload = quantize_blocks(x, group=group)
        metas.append(payload.pop("meta"))
        return payload

    def decompress(payload):
        shape, _, g = metas.pop(0)
        return XF._dequant64(payload["codes"], payload["scales"],
                             g).reshape(shape)

    return compress, decompress


def _fma_add(a, b):
    """``a + q * s`` rounded once to float32 (``b`` the exact product)."""
    return (a.to(torch.float64) + b).to(torch.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("p", HOOK_PS)
def test_hooks_match_reference(reference, p, fused, monkeypatch):
    inputs, want = reference
    key = f"hook_{p}"
    xs = _ranks(inputs[key], torch.float32)
    q = ceil_log2(p)
    compress, decompress = make_compressors(WIRE_GROUP)
    pl = plan(CollectiveSpec(use_fused_kernel=fused), p=p)
    comm = LocalComm(p)
    rs = pl.reduce_scatter(xs, comm, compress=compress,
                           decompress=decompress)
    # a hooked payload is {codes, scales}: two exchanges per round
    assert comm.exchanges == 2 * q
    ar = pl.allreduce(xs, comm, compress=compress, decompress=decompress)
    assert comm.exchanges == 2 * q + 2 * q + q
    for name, got in (("rs", rs), ("ar", ar)):
        w = want[f"{key}_{name}"]
        np.testing.assert_allclose(np.stack([_np(t) for t in got]), w,
                                   rtol=0, atol=2**-21 * np.abs(w).max(),
                                   err_msg=f"{key} hooks {name}")
    monkeypatch.setattr(kernel_ref, "quantize_ref", XF.quantize)
    contracted = plan(CollectiveSpec(op=_fma_add, use_fused_kernel=False),
                      p=p)
    hooks = dict(zip(("compress", "decompress"),
                     _contracted_compressors(WIRE_GROUP)))
    rs = contracted.reduce_scatter(xs, LocalComm(p), **hooks)
    ar = contracted.allreduce(xs, LocalComm(p), **hooks)
    _assert_bits(rs, want[f"{key}_rs"], f"{key} hooks rs contracted")
    _assert_bits(ar, want[f"{key}_ar"], f"{key} hooks ar contracted")


def test_hook_refusals_are_the_reference():
    """Hooks with the wire, non-uniform counts or a baseline kind raise
    the reference's ``ValueError``."""
    from repro.core import CollectiveSpec as RefSpec
    from repro.core import plan as ref_plan
    compress, decompress = make_compressors(4)
    xs = [torch.ones(6, 4)] * 3
    for kw in (dict(wire_dtype="int8"), dict(counts=(2, 2, 2)),
               dict(kind="ring")):
        with pytest.raises(ValueError) as mine:
            plan(CollectiveSpec(**kw), p=3).reduce_scatter(
                xs, LocalComm(3), compress=compress, decompress=decompress)
        with pytest.raises(ValueError) as ref:
            ref_plan(RefSpec(**kw), p=3, axis_name="x").reduce_scatter(
                np.ones((6, 4), np.float32), compress=compress,
                decompress=decompress)
        assert str(mine.value) == str(ref.value)


def test_native_calls_fold_in_rank_order():
    """``LocalComm``'s native collectives: rank-order sums (int32 wraps),
    replicated results, fresh storage, and ``natives`` counted."""
    rng = np.random.default_rng(3)
    p = 4
    xs = [torch.from_numpy(rng.integers(2**30, 2**31 - 1, (p * 2, 3))
                           .astype(np.int32)) for _ in range(p)]
    comm = LocalComm(p)
    want = xs[0] + xs[1] + xs[2] + xs[3]
    for r, t in enumerate(comm.reduce_scatter_sum(xs)):
        assert torch.equal(t, want[2 * r:2 * r + 2])
    ar = comm.all_reduce_sum(xs)
    assert all(torch.equal(t, want) for t in ar)
    assert ar[0].data_ptr() != ar[1].data_ptr()
    a2a = comm.all_to_all([x.reshape(p, 2, 3) for x in xs])
    for j in range(p):
        for k in range(p):
            assert torch.equal(a2a[j][k], xs[k].reshape(p, 2, 3)[j])
    assert (comm.natives, comm.exchanges) == (3, 0)
    mesh = LocalMesh((2, 2), ("x", "y"))
    got = mesh.axis("y").all_gather([x[:2] for x in xs])
    assert torch.equal(got[3], torch.cat([xs[2][:2], xs[3][:2]]))


def test_permute_exchange_counts_and_backward():
    p = 4
    comm = LocalComm(p)
    xs = [torch.full((2,), float(r), requires_grad=True) for r in range(p)]
    pairs = [(i, i ^ 1) for i in range(p)]
    got = comm.permute(xs, pairs)
    assert [float(t[0]) for t in got] == [1, 0, 3, 2]
    assert (comm.exchanges, comm.bytes) == (1, p * 8)
    sum((t * (i + 1)).sum() for i, t in enumerate(got)).backward()
    assert [float(x.grad[0]) for x in xs] == [2, 1, 4, 3]
    assert comm.exchanges == 2  # the backward is the reverse permute
    part = comm.permute([x.detach() for x in xs], [(0, 1)])
    assert float(part[1][0]) == 0 and float(part[0][0]) == 0
    assert comm.bytes == p * 8 * 2 + 8
    with pytest.raises(ValueError, match="one-to-one"):
        comm.permute(xs, [(0, 1), (2, 1)])


def test_dispatch_tables_are_the_reference():
    """``RS_IMPLS`` / ``AR_IMPLS`` / ``AG_IMPLS`` / ``A2A_IMPLS`` name the
    reference's kinds, and each entry computes what the dispatcher does
    for ``CollectiveSpec(kind=...)``."""
    from repro.core import collectives as R
    p = 4
    rng = np.random.default_rng(8)
    xs = [torch.from_numpy(rng.standard_normal((p * 2, 3)).astype(
        np.float32)) for _ in range(p)]
    for name, disp in (("RS_IMPLS", C.reduce_scatter),
                       ("AR_IMPLS", C.allreduce), ("AG_IMPLS", C.allgather),
                       ("A2A_IMPLS", C.alltoall)):
        table = getattr(C, name)
        assert set(table) == set(getattr(R, name)), name
        inp = [x.reshape(p, 2, 3) for x in xs] if name == "A2A_IMPLS" \
            else xs
        for kind, fn in table.items():
            got = fn(inp, LocalComm(p))
            want = disp(inp, LocalComm(p), spec=CollectiveSpec(kind=kind))
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                (name, kind)
