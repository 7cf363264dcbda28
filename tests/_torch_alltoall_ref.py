"""Subprocess worker: the reference's alltoall(v) outputs for the port's
parity test (``test_torch_alltoall.py``).

Reads the inputs the test wrote (``<in.npz>``): ``u_{p}_{dtype}_{blk}``
is the global ``(p, p, blk, cols)`` uniform payload (row r rank r's
``(p, blk, cols)`` input); ``v_{p}_{name}`` the global ``(p, in_height,
cols)`` ragged payload with its counts matrix ``c_{p}_{name}``.  Runs the
JAX package's plans under ``repro.compat.shard_map`` on a ``("x",)`` mesh
of the first p of 8 fake CPU devices: the uniform alltoall on the jnp
backend and on the fused one (Pallas ``permute_rows`` in interpret mode,
``check_vma=False`` as the reference's own checks run it), and the
alltoallv.  Writes ``<out.npz>`` with ``{key}_jnp``, ``{key}_fused`` and
``{key}_v``; bfloat16 results as float32 (exact).

Run: python tests/_torch_alltoall_ref.py <in.npz> <out.npz>
"""
import os
import re
import sys

_inherited = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                    os.environ.get("XLA_FLAGS", ""))
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + _inherited)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import CollectiveSpec, plan  # noqa: E402

DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}


def run(p, x, spec, check_vma=None):
    mesh = compat.make_mesh((p,), ("x",), devices=jax.devices()[:p])
    body = lambda v: plan(spec, axis_name="x").alltoall(v[0])[None]  # noqa
    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("x"),),
                                 out_specs=P("x"), check_vma=check_vma))
    out = np.asarray(f(x))
    return out.astype(np.float32) if x.dtype == jnp.bfloat16 else out


def main(src, dst):
    inp = np.load(src)
    out = {}
    for key in inp.files:
        kind, p = key.split("_")[:2]
        p = int(p)
        if kind == "u":
            x = jnp.asarray(inp[key], DT[key.split("_")[2]])
            out[f"{key}_jnp"] = run(p, x, CollectiveSpec(
                use_fused_kernel=False))
            out[f"{key}_fused"] = run(p, x, CollectiveSpec(
                use_fused_kernel=True), check_vma=False)
        elif kind == "v":
            counts = tuple(tuple(int(c) for c in row)
                           for row in inp["c" + key[1:]])
            out[f"{key}_v"] = run(p, jnp.asarray(inp[key]),
                                  CollectiveSpec(counts=counts))
    np.savez(dst, **out)
    print(f"REFERENCE OK ({len(out)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
