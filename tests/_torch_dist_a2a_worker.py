"""Subprocess worker: one rank of a gloo ``DistComm`` world for
``test_torch_alltoall.py``.

Rank r reads row r of ``x`` in ``<in.npz>`` (its ``(p, blk, cols)``
payload), runs the port's uniform circulant alltoall over
``torch.distributed`` (eager and fused, one ``shift`` per round), and
writes both results and its exchange count to ``<out_prefix>.<r>.npz``.

Run: python tests/_torch_dist_a2a_worker.py <rank> <world> <port> <in.npz> <out_prefix>
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.comm import DistComm  # noqa: E402
from repro_torch.core import circulant_alltoall  # noqa: E402


def main(rank, world, port, src, prefix):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        comm = DistComm()
        x = torch.from_numpy(np.load(src)["x"][rank])
        out = {f"fused{int(f)}": circulant_alltoall(
            [x], comm, use_fused_kernel=f)[0].numpy() for f in (False, True)}
        out["exchanges"] = np.asarray(comm.exchanges)
        np.savez(f"{prefix}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
