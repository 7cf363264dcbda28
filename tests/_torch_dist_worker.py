"""Subprocess worker: one rank of a gloo ``DistComm`` world for
``test_torch_collectives.py``.

Rank r reads row r of every array in ``<in.npz>``, runs the port's
circulant reduce-scatter and allreduce (eager and fused, add and max)
over ``torch.distributed`` with one ``shift`` per round, and writes its
results and exchange count to ``<out_prefix>.<r>.npz``.

Run: python tests/_torch_dist_worker.py <rank> <world> <port> <in.npz> <out_prefix>
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.comm import DistComm  # noqa: E402
from repro_torch.core import CollectiveSpec, plan  # noqa: E402


def main(rank, world, port, src, prefix):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        comm = DistComm()
        inp = np.load(src)
        out = {}
        for key in inp.files:
            x = torch.from_numpy(inp[key][rank])
            for op in ("add", "max"):
                for fused in (False, True):
                    pl = plan(CollectiveSpec(op=op, use_fused_kernel=fused),
                              p=world)
                    tag = f"{key}_{op}_{int(fused)}"
                    out[f"{tag}_rs"] = pl.reduce_scatter([x], comm)[0].numpy()
                    out[f"{tag}_ar"] = pl.allreduce([x], comm)[0].numpy()
        out["exchanges"] = np.asarray(comm.exchanges)
        np.savez(f"{prefix}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
