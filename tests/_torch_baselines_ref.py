"""Subprocess worker: the reference's baselines, broadcast, hierarchical
collectives and per-round hooks, for ``test_torch_baselines.py``.

Reads the inputs the test wrote (``<in.npz>``) and runs the JAX
package's plans under ``repro.compat.shard_map`` on meshes of the first
p of 12 fake CPU devices, writing ``<out.npz>``:

* ``{p}_{dtype}`` (global ``(p, n, cols)``, row r rank r's payload):
  ``..._ring_rs_{op}``, ``..._ring_ar_{op}``, ``..._rh_rs_{op}`` (power-of-
  two p), ``..._xla_rs``, ``..._xla_ar`` and ``..._xla_ag`` (of each
  rank's first ``n / p`` rows), through ``plan(CollectiveSpec(kind=...))``;
* ``bc_{p}_{dtype}`` (``(p, blk, cols)``): ``..._{schedule}``, the
  ``kind="broadcast"`` plan's result;
* ``hier_{p}`` (``(p, n, cols)`` float32) and ``hierblk_{p}`` (``(p, blk,
  cols)``) on a ``(p // g, g)`` mesh, axes ``("x", "y")``:
  ``..._{rs|ag|ar}`` and, on the int8 wire (group ``WIRE_GROUP``),
  ``..._w{rs|ag|ar}``;
* ``hook_{p}`` (float32): the circulant reduce-scatter and allreduce
  with ``make_compressors(WIRE_GROUP, backend="jnp")`` hooks,
  ``..._rs`` and ``..._ar``.

Every plan runs on the jnp backend.  bfloat16 results are written as
float32 (exact).

Run: python tests/_torch_baselines_ref.py <in.npz> <out.npz>
"""
import os
import re
import sys

_inherited = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                    os.environ.get("XLA_FLAGS", ""))
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=12 "
                           + _inherited)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import CollectiveSpec, plan  # noqa: E402
from repro.core import collectives as C  # noqa: E402
from repro.kernels.ops import make_compressors  # noqa: E402

OPS = ("add", "max", "min")
SCHEDULES = ("halving", "power2")
WIRE_GROUP = 4
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}


def shmap(mesh, body, n_out, spec=P("x")):
    return jax.jit(compat.shard_map(
        lambda v: tuple(o[None] for o in body(v[0])), mesh=mesh,
        in_specs=(spec,), out_specs=(spec,) * n_out, check_vma=False))


def baselines(p, x):
    mesh = compat.make_mesh((p,), ("x",), devices=jax.devices()[:p])
    pow2 = p & (p - 1) == 0
    names = []
    for op in OPS:
        names += [f"ring_rs_{op}", f"ring_ar_{op}"]
        if pow2:
            names.append(f"rh_rs_{op}")
    names += ["xla_rs", "xla_ar", "xla_ag"]
    blk = x.shape[1] // p

    def body(v):
        outs = []
        for op in OPS:
            ring = plan(CollectiveSpec(kind="ring", op=op), axis_name="x")
            outs += [ring.reduce_scatter(v), ring.allreduce(v)]
            if pow2:
                rh = plan(CollectiveSpec(kind="recursive_halving", op=op),
                          axis_name="x")
                outs.append(rh.reduce_scatter(v))
        xla = plan(CollectiveSpec(kind="xla"), axis_name="x")
        outs += [xla.reduce_scatter(v), xla.allreduce(v),
                 xla.allgather(v[:blk])]
        return outs

    return names, shmap(mesh, body, len(names))(x)


def broadcast(p, x):
    mesh = compat.make_mesh((p,), ("x",), devices=jax.devices()[:p])

    def body(v):
        return [plan(CollectiveSpec(kind="broadcast", schedule=s),
                     axis_name="x").broadcast(v) for s in SCHEDULES]

    return list(SCHEDULES), shmap(mesh, body, len(SCHEDULES))(x)


def hierarchical(p, a, b, x, blocks):
    mesh = compat.make_mesh((a, b), ("x", "y"), devices=jax.devices()[:p])
    axes = ("x", "y")
    spec = P(("x", "y"))
    out = {}
    for pre, kw in (("", {}), ("w", {"wire_dtype": "int8",
                                     "wire_group": WIRE_GROUP})):
        kw = dict(kw, use_fused_kernel=False)
        rs, ar = shmap(mesh, lambda v: [
            C.hierarchical_reduce_scatter(v, axes, **kw),
            C.hierarchical_allreduce(v, axes, **kw)], 2, spec)(x)
        (ag,) = shmap(mesh, lambda v: [
            C.hierarchical_allgather(v, axes, **kw)], 1, spec)(blocks)
        out.update({pre + "rs": rs, pre + "ar": ar, pre + "ag": ag})
    return out


def hooks(p, x):
    mesh = compat.make_mesh((p,), ("x",), devices=jax.devices()[:p])
    compress, decompress = make_compressors(WIRE_GROUP, backend="jnp")

    def body(v):
        pl = plan(CollectiveSpec(use_fused_kernel=False), axis_name="x")
        return [pl.reduce_scatter(v, compress=compress,
                                  decompress=decompress),
                pl.allreduce(v, compress=compress, decompress=decompress)]

    return ["rs", "ar"], shmap(mesh, body, 2)(x)


def _store(out, key, name, r, dtype):
    r = np.asarray(r)
    out[f"{key}_{name}"] = r.astype(np.float32) if dtype == "bfloat16" else r


def main(src, dst):
    inp = np.load(src)
    out = {}
    for key in inp.files:
        kind = key.split("_")[0]
        if kind == "bc":
            _, p, dt = key.split("_", 2)
            names, res = broadcast(int(p), jnp.asarray(inp[key], DT[dt]))
        elif kind == "hook":
            dt = "float32"
            names, res = hooks(int(key.split("_")[1]), jnp.asarray(inp[key]))
        elif kind == "g":
            p, g = int(key.split("_")[1]), int(inp[key])
            res = hierarchical(p, p // g, g, jnp.asarray(inp[f"hier_{p}"]),
                               jnp.asarray(inp[f"hierblk_{p}"]))
            names, res, dt, key = list(res), list(res.values()), \
                "float32", f"hier_{p}"
        elif kind in ("hier", "hierblk"):
            continue  # run with their g_{p} entry
        else:
            p, dt = key.split("_", 1)
            names, res = baselines(int(p), jnp.asarray(inp[key], DT[dt]))
        for name, r in zip(names, res):
            _store(out, key, name, r, dt)
    np.savez(dst, **out)
    print(f"REFERENCE OK ({len(out)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
