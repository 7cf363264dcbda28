"""Subprocess worker: the reference's expert-parallel MoE layer for the
port's parity test (``test_torch_moe.py``).

Reads ``<in.npz>``: per case ``{case}/cfg`` (pe, e, capacity factor),
the MoE parameters ``{case}/router``, ``w_gate``, ``w_up``, ``w_down``,
the global input ``{case}/x`` ``(pe, B, S, d)`` and cotangent weights
``{case}/w``.  Runs ``repro.models.moe.moe_ffn`` with
``moe_dispatch="ep"`` under ``repro.compat.shard_map`` over an ``("x",)``
mesh of pe fake CPU devices (``check_vma=False``, as the reference's own
ep checks run it), and differentiates ``sum(out * w) + aux`` inside the
region, so each device's gradient is that of the sum of every device's
value through the transposed exchanges.  Writes ``<out.npz>`` with
``{case}/out``, ``{case}/aux`` and per-device gradients ``{case}/g_<leaf>``
and ``{case}/g_x``.

Run: python tests/_torch_moe_ref.py <in.npz> <out.npz>
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
from repro.models.config import ModelConfig  # noqa: E402
from repro.models.moe import moe_ffn  # noqa: E402

LEAVES = ("router", "w_gate", "w_up", "w_down")


def config(e, cf, d, ff, ep):
    return ModelConfig(name="t", family="moe", n_layers=1, d_model=d,
                       n_heads=2, n_kv_heads=2, d_ff=ff, vocab_size=64,
                       head_dim=8, n_experts=e, experts_per_token=2,
                       capacity_factor=cf, dtype="float32",
                       moe_dispatch="ep" if ep else "global", ep_axis="x")


def run(pe, cfg, params, x, w):
    mesh = compat.make_mesh((pe,), ("x",), devices=jax.devices()[:pe])

    def body(p, x, w):
        def f(p, x):
            o, a = moe_ffn(p, cfg, x[0])
            return jnp.sum(o * w[0]) + a, (o, a)

        (_, (o, a)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(p, x)
        return o[None], a[None], jax.tree.map(lambda g: g[None], gp), gx

    pspec = {k: P() for k in LEAVES}
    gspec = {k: P("x") for k in LEAVES}
    f = jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=(pspec, P("x"), P("x")),
        out_specs=(P("x"), P("x"), gspec, P("x")), check_vma=False))
    return f(params, x, w)


def main(src, dst):
    inp = np.load(src)
    out = {}
    for case in sorted({k.split("/")[0] for k in inp.files}):
        pe, e, cf, d, ff = inp[f"{case}/cfg"].tolist()
        cfg = config(int(e), float(cf), int(d), int(ff), ep=True)
        params = {k: jnp.asarray(inp[f"{case}/{k}"]) for k in LEAVES}
        o, a, gp, gx = run(int(pe), cfg, params,
                           jnp.asarray(inp[f"{case}/x"]),
                           jnp.asarray(inp[f"{case}/w"]))
        out[f"{case}/out"], out[f"{case}/aux"] = np.asarray(o), np.asarray(a)
        out[f"{case}/g_x"] = np.asarray(gx)
        for k in LEAVES:
            out[f"{case}/g_{k}"] = np.asarray(gp[k])
    np.savez(dst, **out)
    print(f"REFERENCE OK ({len(out)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
