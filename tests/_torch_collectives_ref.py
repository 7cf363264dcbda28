"""Subprocess worker: the reference's circulant RS / AR / AG outputs for
the port's collective parity test (``test_torch_collectives.py``).

Reads the inputs the test wrote (``<in.npz>``: key ``{p}_{dtype}`` is the
global ``(p, n, cols)`` array, row r rank r's payload), runs the JAX
package's plans under ``repro.compat.shard_map`` on a ``("x",)`` mesh of
the first p of 8 fake CPU devices, on the jnp backend, and writes
``<out.npz>`` with ``{p}_{dtype}_{rs|ar}_{op}`` and ``{p}_{dtype}_ag``;
for float32 payloads also the int8 wire's (``jnp+int8``, quantization
group ``WIRE_GROUP``) ``{p}_float32_{wrs|war}_{op}`` and
``{p}_float32_wag``.  bfloat16 results are written as float32 (exact).

Run: python tests/_torch_collectives_ref.py <in.npz> <out.npz>
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

OPS = ("add", "max", "min")
WIRE_GROUP = 4
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}


def run(p, x, blk, wire):
    mesh = compat.make_mesh((p,), ("x",), devices=jax.devices()[:p])
    wires = (None, "int8") if wire else (None,)

    def body(v):
        v = v[0]
        outs = []
        for wd in wires:
            for op in OPS:
                pl = plan(CollectiveSpec(op=op, use_fused_kernel=False,
                                         wire_dtype=wd,
                                         wire_group=WIRE_GROUP),
                          axis_name="x")
                outs += [pl.reduce_scatter(v), pl.allreduce(v)]
            pl = plan(CollectiveSpec(use_fused_kernel=False, wire_dtype=wd,
                                     wire_group=WIRE_GROUP), axis_name="x")
            outs.append(pl.allgather(v[:blk]))
        return tuple(o[None] for o in outs)

    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("x"),),
                                 out_specs=(P("x"),) * (7 * len(wires))))
    return f(x)


def main(src, dst):
    inp = np.load(src)
    out = {}
    for key in inp.files:
        p, dt = key.split("_", 1)
        p = int(p)
        x = jnp.asarray(inp[key], DT[dt])
        blk = x.shape[1] // p
        wire = dt == "float32"
        res = run(p, x, blk, wire)
        names = [f"{kind}_{op}" for op in OPS for kind in ("rs", "ar")]
        names += ["ag"]
        if wire:
            names += ["w" + n for n in names]
        for name, r in zip(names, res):
            r = np.asarray(r)
            out[f"{key}_{name}"] = (r.astype(np.float32) if dt == "bfloat16"
                                    else r)
    np.savez(dst, **out)
    print(f"REFERENCE OK ({len(out)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
