"""The software-pipelined round protocol of the port's plans.

``reduce_scatter_pipelined`` / ``allgather_pipelined`` run many payloads
of one plan with their rounds interleaved: payload b's round-k exchange
is posted (``comm.post``) before payload b-1's round-k fold.  Each
payload's result must be BITWISE its one-shot result (the same round
ops run, split at the round seam), with ``len(payloads) * rounds``
exchanges, for 1-4 payloads of different shapes at p ∈ {2, 3, 5, 8},
eager, fused (its plain version here) and on the int8 wire (whose
round-0 quantization and per-round requantization keep their seam).  A
spy communicator records the order of posts and waits.  p = 1 is the
identity, and the protocol's refusals are the reference's
(``tests/test_plan_async.py``).  On gloo, one spawn of 4 processes
(``_torch_dist_worker.py pipelined``) runs the pipelined reduce-scatter
and allgather over a ``DistComm`` of a 3-rank process group and the
hierarchical reduce-scatter and allreduce over a ``DistMesh`` of 2x2,
each bitwise equal to ``LocalComm`` / ``LocalMesh``; the same spawn
holds the native calls over the 3-rank group (one native call each, no
exchange; the sums within float32 rounding, since gloo's summation order
is its own) and the ring and recursive-halving (``comm.permute``)
reduce-scatters over the world, bitwise.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.comm import LocalComm, LocalMesh
from repro_torch.core import CollectiveSpec, RoundState, ceil_log2, plan
from repro_torch.core import collectives as C
from repro_torch.kernels import make_compressors

HERE = os.path.dirname(os.path.abspath(__file__))
PS = (2, 3, 5, 8)
#: the backends of the pipelined runs (``_torch_dist_worker.PIPE_SPECS``).
PIPE_SPECS = {"eager": CollectiveSpec(use_fused_kernel=False),
              "fused": CollectiveSpec(use_fused_kernel=True),
              "int8": CollectiveSpec(use_fused_kernel=True,
                                     wire_dtype="int8", wire_group=4)}
#: per-rank payload shapes of the pipelined runs: block rows of 6, 3, 4
#: (a trailing dim) and 5 columns.
SHAPES = ((6,), (3,), (4, 2), (5,))


def _payloads(p, n, seed):
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(rng.standard_normal(
        (p * s[0], *s[1:])).astype(np.float32)) for _ in range(p)]
        for s in SHAPES[:n]]


@pytest.mark.parametrize("backend", sorted(PIPE_SPECS))
@pytest.mark.parametrize("p", PS)
def test_pipelined_equals_one_shot(p, backend):
    pl = plan(PIPE_SPECS[backend], p=p)
    q = ceil_log2(p)
    for n in range(1, len(SHAPES) + 1):
        xss = _payloads(p, n, seed=p * 10 + n)
        comm = LocalComm(p)
        got = pl.reduce_scatter_pipelined(iter(xss), comm)
        assert comm.exchanges == n * q
        for xs, res in zip(xss, got):
            one = pl.reduce_scatter(xs, LocalComm(p))
            assert all(torch.equal(a, b) for a, b in zip(res, one))
        blocks = [[x[:2] for x in xs] for xs in xss]
        comm = LocalComm(p)
        got = pl.allgather_pipelined(blocks, comm)
        assert comm.exchanges == n * q
        for xs, res in zip(blocks, got):
            one = pl.allgather(xs, LocalComm(p))
            assert all(torch.equal(a, b) for a, b in zip(res, one))


@pytest.mark.parametrize("p", (3, 5))
def test_pipelined_hooks_equal_one_shot(p):
    """Payloads of different shapes through the hooks: each decompress
    gets the meta of its own payload, and each result is its one-shot
    one (two exchanges per round: codes and scales)."""
    pl = plan(CollectiveSpec(use_fused_kernel=False), p=p)
    xss = _payloads(p, 4, seed=99)
    comm = LocalComm(p)
    got = pl.reduce_scatter_pipelined(xss, comm, **dict(zip(
        ("compress", "decompress"), make_compressors(4))))
    assert comm.exchanges == 4 * 2 * ceil_log2(p)
    for xs, res in zip(xss, got):
        one = pl.reduce_scatter(xs, LocalComm(p), **dict(zip(
            ("compress", "decompress"), make_compressors(4))))
        assert all(torch.equal(a, b) for a, b in zip(res, one))


class SpyComm(LocalComm):
    """A ``LocalComm`` recording each post and wait as (event, payload
    rows), the payloads told apart by their block rows."""

    def __init__(self, p):
        super().__init__(p)
        self.log = []

    def post(self, xs, s):
        tag = xs[0].shape[-1]
        self.log.append(("post", tag))
        pending = super().post(xs, s)
        log = self.log

        class Spy:
            def wait(self):
                log.append(("wait", tag))
                return pending.wait()
        return Spy()


def test_pipelined_posts_before_previous_fold():
    p, n = 5, 3
    pl = plan(CollectiveSpec(use_fused_kernel=True), p=p)
    xss = _payloads(p, n, seed=1)
    comm = SpyComm(p)
    pl.reduce_scatter_pipelined(xss, comm)
    tags = [xs[0].reshape(p, -1).shape[1] for xs in xss]  # columns: 6, 3, 4
    want = []
    for _ in range(ceil_log2(p)):
        want += [("post", tags[0]), ("post", tags[1]), ("wait", tags[0]),
                 ("post", tags[2]), ("wait", tags[1]), ("wait", tags[2])]
    assert comm.log == want


def test_p1_pipelined_identity():
    pl = plan(CollectiveSpec(), p=1)
    xs = [torch.arange(4.0)], [torch.ones(2, 3)]
    outs = pl.reduce_scatter_pipelined(xs, LocalComm(1))
    assert all(o[0] is x[0] for o, x in zip(outs, xs))
    outs = pl.allgather_pipelined(xs, LocalComm(1))
    assert all(o[0] is x[0] for o, x in zip(outs, xs))
    st = pl.rs_begin(xs[0], LocalComm(1))
    assert st.done and st.nrounds == 0
    with pytest.raises(ValueError, match="phase complete"):
        pl.start_round(st)
    assert pl.rs_end(st)[0] is xs[0][0]


def _state(pl, **kw):
    return RoundState(plan=pl, comm=LocalComm(pl.p), phase="rs",
                      backend="eager", **kw)


def test_protocol_order_errors():
    pl = plan(CollectiveSpec(), p=4)
    with pytest.raises(ValueError, match="phase complete"):
        pl.start_round(_state(pl, nrounds=2, k=2))
    with pytest.raises(ValueError, match="already started"):
        pl.start_round(_state(pl, nrounds=2, started=True))
    with pytest.raises(ValueError, match="in flight"):
        pl.finish_round(_state(pl, nrounds=2))
    with pytest.raises(ValueError, match="unfinished"):
        pl.rs_end(_state(pl, nrounds=2, k=1))
    with pytest.raises(ValueError, match="mid-rs"):
        pl.ag_end(_state(pl, nrounds=2, k=2))
    other = plan(CollectiveSpec(schedule="power2"), p=4)
    with pytest.raises(ValueError, match="different plan"):
        pl.start_round(_state(other, nrounds=2))


@pytest.mark.parametrize("kind", ["ring", "xla"])
def test_baseline_backends_have_no_async(kind):
    pl = plan(CollectiveSpec(kind=kind), p=4)
    with pytest.raises(NotImplementedError, match="multi-call"):
        pl.rs_begin([torch.zeros(8)] * 4, LocalComm(4))
    with pytest.raises(NotImplementedError, match="multi-call"):
        pl.ag_begin([torch.zeros(2)] * 4, LocalComm(4))
    with pytest.raises(NotImplementedError, match="multi-call"):
        pl.reduce_scatter_pipelined([[torch.zeros(8)] * 4], LocalComm(4))


def test_nonuniform_has_no_async():
    pl = plan(CollectiveSpec(counts=(3, 1, 4, 1)), p=4)
    with pytest.raises(NotImplementedError, match="async-capable"):
        pl.rs_begin([torch.zeros(9)] * 4, LocalComm(4))


def test_dist_pipelined_and_mesh_gloo_match_local(tmp_path):
    """One spawn of 4 gloo processes: the pipelined RS / AG and the
    native calls over a 3-rank group's ``DistComm``, the hierarchical RS
    / AR over a 2x2 ``DistMesh`` and the ring and recursive-halving RS
    over the world, equal to the in-process worlds."""
    world = 4
    rng = np.random.default_rng(17)
    inputs = {f"pipe_{b}": rng.standard_normal(
        (3, 3 * s[0], *s[1:])).astype(np.float32)
        for b, s in enumerate(SHAPES[:3])}
    inputs["hier"] = rng.standard_normal((world, 8, 3)).astype(np.float32)
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
         str(tmp_path / "out"), "pipelined"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    xss = [[torch.from_numpy(a) for a in inputs[f"pipe_{b}"]]
           for b in range(3)]
    for name, spec in PIPE_SPECS.items():
        want = plan(spec, p=3).reduce_scatter_pipelined(xss, LocalComm(3))
        for b in range(3):
            for r in range(3):
                np.testing.assert_array_equal(outs[r][f"{name}_rs_{b}"],
                                              want[b][r].numpy())
    want = C.allgather_pipelined([[x[:2] for x in xs] for xs in xss],
                                 LocalComm(3))
    for b in range(3):
        for r in range(3):
            np.testing.assert_array_equal(outs[r][f"ag_{b}"],
                                          want[b][r].numpy())
    for r in range(3):  # 3 payloads x 2 rounds x (3 RS backends + AG)
        assert int(outs[r]["pipe_exchanges"]) == 3 * 2 * 4
    xs = [torch.from_numpy(a) for a in inputs["hier"]]
    for fused in (0, 1):
        kw = dict(use_fused_kernel=bool(fused))
        mesh = LocalMesh((2, 2), ("x", "y"))
        rs = C.hierarchical_reduce_scatter(xs, mesh, ("x", "y"), **kw)
        ar = C.hierarchical_allreduce(xs, mesh, ("x", "y"), **kw)
        for r in range(world):
            np.testing.assert_array_equal(outs[r][f"hier_rs_{fused}"],
                                          rs[r].numpy())
            np.testing.assert_array_equal(outs[r][f"hier_ar_{fused}"],
                                          ar[r].numpy())
    for r in range(world):  # per axis: (RS 1 + AR 2) x 2 backends
        assert outs[r]["hier_exchanges"].tolist() == [6, 6]
    # the native calls over the 3-rank group, and the ring and recursive
    # halving (``comm.permute``) over the whole world
    x0 = xss[0]
    local = LocalComm(3)
    want = {"native_rs": C.xla_reduce_scatter(x0, local),
            "native_ar": C.xla_allreduce(x0, local),
            "native_ag": C.xla_allgather([x[:2] for x in x0], local),
            "native_a2a": C.xla_alltoall([x.reshape(3, -1) for x in x0],
                                         local)}
    for r in range(3):
        assert outs[r]["natives"].tolist() == [4, 3 * 2 * 4]
        for key, vals in want.items():
            np.testing.assert_allclose(outs[r][key], vals[r].numpy(),
                                       rtol=2e-6, atol=1e-6, err_msg=key)
    local = LocalComm(world)
    ring = C.ring_reduce_scatter(xs, local)
    rh = C.recursive_halving_reduce_scatter(xs, local)
    for r in range(world):
        np.testing.assert_array_equal(outs[r]["ring_rs"], ring[r].numpy())
        np.testing.assert_array_equal(outs[r]["rh_rs"], rh[r].numpy())
        # ring p - 1 = 3, recursive halving log2 4 = 2; p - 1 blocks of
        # 2 x 3 float32 leave each rank per reduce-scatter
        assert int(outs[r]["base_exchanges"]) == 5
        assert int(outs[r]["base_bytes"]) == 2 * 3 * 2 * 3 * 4
