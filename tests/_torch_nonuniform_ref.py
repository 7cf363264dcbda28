"""Subprocess worker: the reference's Corollary-3 non-uniform RS / AG / AR
outputs for the port's parity test (``test_torch_nonuniform.py``).

Reads ``<in.npz>`` (key ``{p}_{pattern}_{kind}``: the global ``(p, N,
COLS)`` array, row r rank r's payload, ``N = sum(counts)``; ``kind`` is
``f32``, ``i32``, ``nan`` (float32 with NaNs) or ``bf16`` (bfloat16
values held as float32), and ``{p}_{pattern}_counts``), runs the JAX
package's ``CollectiveSpec(counts=...)`` plans under
``repro.compat.shard_map`` on a ``("x",)`` mesh of the first p of 8 fake
CPU devices, every case of one (p, pattern) in one jitted body, and
writes ``<out.npz>`` with ``{p}_{pattern}_{name}`` for every name of
:func:`case_names`.  bfloat16 results are written as float32 (exact).

Run: python tests/_torch_nonuniform_ref.py <in.npz> <out.npz>
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
from repro.core.conformance import NONUNIFORM_SCHEDULES  # noqa: E402

OPS = ("add", "max", "min")
KINDS = ("f32", "i32", "nan", "bf16")


def case_names():
    """(name, kind, collective, schedule, op) of every case, in order."""
    out = []
    for sched in NONUNIFORM_SCHEDULES:
        for kind in ("f32", "i32"):
            for op in OPS:
                for coll in ("rs", "ar"):
                    out.append((f"{sched}_{kind}_{op}_{coll}", kind, coll,
                                sched, op))
        out.append((f"{sched}_f32_ag", "f32", "ag", sched, "add"))
    # NaN propagation and the bf16 rounding do not depend on the schedule.
    for kind, ops in (("nan", ("max", "min")), ("bf16", ("add",))):
        for op in ops:
            for coll in ("rs", "ar"):
                out.append((f"halving_{kind}_{op}_{coll}", kind, coll,
                            "halving", op))
    return out


def run(p, counts, arrays):
    mesh = compat.make_mesh((p,), ("x",), devices=jax.devices()[:p])
    names = case_names()
    bmax = max(counts)

    def body(*vs):
        v = {k: a[0] for k, a in zip(KINDS, vs)}
        outs = []
        for _, kind, coll, sched, op in names:
            pl = plan(CollectiveSpec(schedule=sched, op=op, counts=counts),
                      axis_name="x")
            if coll == "rs":
                outs.append(pl.reduce_scatter(v[kind]))
            elif coll == "ar":
                # CollectivePlan.allreduce is exactly this; reusing the
                # RS traced just before halves the body's tracing time.
                outs.append(pl.allgather(outs[-1]))
            else:
                outs.append(pl.allgather(v[kind][:bmax]))
        return tuple(o[None] for o in outs)

    f = jax.jit(compat.shard_map(body, mesh=mesh,
                                 in_specs=(P("x"),) * len(KINDS),
                                 out_specs=(P("x"),) * len(names)))
    return dict(zip((n[0] for n in names), f(*arrays)))


def main(src, dst):
    inp = np.load(src)
    out = {}
    for key in sorted(k for k in inp.files if k.endswith("_counts")):
        prefix = key[:-len("_counts")]
        p = int(prefix.split("_", 1)[0])
        counts = tuple(int(c) for c in inp[key])
        arrays = [jnp.asarray(inp[f"{prefix}_i32"]) if kind == "i32" else
                  jnp.asarray(inp[f"{prefix}_{kind}"],
                              jnp.bfloat16 if kind == "bf16" else
                              jnp.float32) for kind in KINDS]
        for name, r in run(p, counts, arrays).items():
            r = np.asarray(r)
            out[f"{prefix}_{name}"] = (r.astype(np.float32)
                                       if r.dtype == jnp.bfloat16 else r)
    np.savez(dst, **out)
    print(f"REFERENCE OK ({len(out)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
