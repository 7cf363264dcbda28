"""Subprocess worker: one rank of a gloo ``DistComm`` world for
``test_torch_collectives.py``.

Rank r reads row r of every array in ``<in.npz>``, runs the port's
circulant reduce-scatter and allreduce (eager and fused, add and max)
over ``torch.distributed`` with one ``shift`` per round, and writes its
results and exchange count to ``<out_prefix>.<r>.npz``.  Arrays keyed
``nu_*`` run the non-uniform (Corollary 3) reduce-scatter and allreduce
over the per-rank block rows in ``nu_counts`` (add and max), counted
apart in ``nu_exchanges`` and ``nu_bytes``.

With a sixth argument ``pipelined`` (``test_torch_pipelined.py``) the
world is 4 processes: ranks 0-2 run the software-pipelined
reduce-scatter and allgather of the ``pipe_*`` payloads over a
``DistComm`` of a 3-rank process group (eager, fused and on the int8
wire: ``{backend}_rs_{b}``, ``ag_{b}``, ``pipe_exchanges``) and the
native collectives of ``pipe_0`` over that group (``native_{rs|ar|ag|
a2a}``, ``natives``); all 4 run the hierarchical reduce-scatter and
allreduce of ``hier`` over a ``DistMesh`` of 2x2 (``hier_{rs|ar}_
{fused}``, ``hier_exchanges``: per axis) and the ring and recursive
halving reduce-scatters of ``hier`` over the whole world
(``{ring|rh}_rs``, ``base_exchanges``, ``base_bytes``).

Run: python tests/_torch_dist_worker.py <rank> <world> <port> <in.npz> <out_prefix> [pipelined]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.comm import DistComm, DistMesh  # noqa: E402
from repro_torch.core import CollectiveSpec, plan  # noqa: E402
from repro_torch.core import collectives as C  # noqa: E402

#: the pipelined run's backends (``test_torch_pipelined.PIPE_SPECS``).
PIPE_SPECS = {"eager": CollectiveSpec(use_fused_kernel=False),
              "fused": CollectiveSpec(use_fused_kernel=True),
              "int8": CollectiveSpec(use_fused_kernel=True,
                                     wire_dtype="int8", wire_group=4)}


def pipelined(rank, inp):
    """The pipelined and hierarchical runs of a 4-process world."""
    mesh = DistMesh((2, 2), ("x", "y"))
    sub = dist.new_group([0, 1, 2])  # every process takes part
    out = {}
    if rank < 3:
        comm = DistComm(sub)
        n = sum(k.startswith("pipe_") for k in inp.files)
        xss = [[torch.from_numpy(inp[f"pipe_{b}"][rank])] for b in range(n)]
        for name, spec in PIPE_SPECS.items():
            res = plan(spec, p=3).reduce_scatter_pipelined(xss, comm)
            for b, r in enumerate(res):
                out[f"{name}_rs_{b}"] = r[0].numpy()
        blocks = [[x[0][:2]] for x in xss]
        res = C.allgather_pipelined(blocks, comm)
        for b, r in enumerate(res):
            out[f"ag_{b}"] = r[0].numpy()
        out["pipe_exchanges"] = np.asarray(comm.exchanges)
        x = xss[0]
        out["native_rs"] = C.xla_reduce_scatter(x, comm)[0].numpy()
        out["native_ar"] = C.xla_allreduce(x, comm)[0].numpy()
        out["native_ag"] = C.xla_allgather([x[0][:2]], comm)[0].numpy()
        out["native_a2a"] = C.xla_alltoall([x[0].reshape(3, -1)],
                                           comm)[0].numpy()
        out["natives"] = np.asarray([comm.natives, comm.exchanges])
    x = torch.from_numpy(inp["hier"][rank])
    for fused in (False, True):
        kw = dict(use_fused_kernel=fused)
        out[f"hier_rs_{int(fused)}"] = C.hierarchical_reduce_scatter(
            [x], mesh, ("x", "y"), **kw)[0].numpy()
        out[f"hier_ar_{int(fused)}"] = C.hierarchical_allreduce(
            [x], mesh, ("x", "y"), **kw)[0].numpy()
    out["hier_exchanges"] = np.asarray([mesh.axis("x").exchanges,
                                        mesh.axis("y").exchanges])
    world = DistComm()
    out["ring_rs"] = C.ring_reduce_scatter([x], world)[0].numpy()
    out["rh_rs"] = C.recursive_halving_reduce_scatter([x], world)[0].numpy()
    out["base_exchanges"] = np.asarray(world.exchanges)
    out["base_bytes"] = np.asarray(world.bytes)
    return out


def main(rank, world, port, src, prefix, mode=None):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        if mode == "pipelined":
            np.savez(f"{prefix}.{rank}.npz", **pipelined(rank, np.load(src)))
            return
        comm = DistComm()
        inp = np.load(src)
        out = {}
        for key in (k for k in inp.files if not k.startswith("nu_")):
            x = torch.from_numpy(inp[key][rank])
            for op in ("add", "max"):
                for fused in (False, True):
                    pl = plan(CollectiveSpec(op=op, use_fused_kernel=fused),
                              p=world)
                    tag = f"{key}_{op}_{int(fused)}"
                    out[f"{tag}_rs"] = pl.reduce_scatter([x], comm)[0].numpy()
                    out[f"{tag}_ar"] = pl.allreduce([x], comm)[0].numpy()
        out["exchanges"] = np.asarray(comm.exchanges)
        comm = DistComm()
        counts = tuple(int(c) for c in inp["nu_counts"])
        for key in (k for k in inp.files if k.startswith("nu_")
                    and k != "nu_counts"):
            x = torch.from_numpy(inp[key][rank])
            for op in ("add", "max"):
                pl = plan(CollectiveSpec(op=op, counts=counts), p=world)
                out[f"{key}_{op}_rs"] = pl.reduce_scatter([x], comm)[0].numpy()
                out[f"{key}_{op}_ar"] = pl.allreduce([x], comm)[0].numpy()
        out["nu_exchanges"] = np.asarray(comm.exchanges)
        out["nu_bytes"] = np.asarray(comm.bytes)
        np.savez(f"{prefix}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], *sys.argv[6:])
