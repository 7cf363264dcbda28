"""Subprocess worker: the reference's 4-step ZeRO-1 trajectory for the
port's parity test (``test_torch_zero1.py``).

Drives ``repro.optim.zero1.zero1_step`` directly under
``repro.compat.shard_map`` on a ``("data",)`` mesh of the first p of 4
fake CPU devices,
the model built with ``recipe=None`` and ``check_vma=False``: the
reference's step function without its launcher (whose zero1 mode does
not run on JAX 0.9's explicit mesh axes).  qwen3-1.7b scaled down,
seq 16, global batch p, the launcher's AdamW defaults, halving
schedule on the jnp backend.  At p = 3: the circulant sync exact, on the
int8 wire with error feedback, and exact with a bfloat16 reduce-scatter
payload (``rs_dtype="bfloat16"``); bucketed (``bucket_bytes=BUCKET``)
exact and on the int8 wire with error feedback; and the ``ring``,
``xla`` and ``allreduce`` impls.  At p = 2 and 4: the exact circulant
sync.  Writes ``<out.npz>``: the initial parameters (``init/<path>``),
and for each run its per-step losses and the parameters after the last
step: ``losses`` / ``final/<path>`` (exact), ``int8_``, ``bf16_``,
``bucket_``, ``bucket_int8_``, ``ring_``, ``xla_``, ``allreduce_``,
``p2_`` and ``p4_`` prefixed likewise; ``[runs]`` names the runs to
take (their prefixes, comma-separated, ``f32`` for the exact run; all
of them by default), so each test file spawns only the runs its tests
read.  ``train`` is also the recipe of ``_torch_zero1_archs_ref.py``
(the other architecture families).

Run: python tests/_torch_zero1_ref.py <out.npz> [runs]
"""
import os
import re
import sys

_inherited = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                    os.environ.get("XLA_FLAGS", ""))
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + _inherited)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import for_model  # noqa: E402
from repro.models import build  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.optim.zero1 import (GradSyncConfig, init_zero1_state,  # noqa: E402
                               zero1_state_specs, zero1_step)

STEPS, SEQ = 4, 16
#: bucket size of the bucketed runs (= test_torch_zero1.BUCKET): it
#: splits the scaled-down model's larger leaves across buckets.
BUCKET = 30_000
#: (prefix, world, GradSyncConfig kwargs) of every run
RUNS = (("", 3, {}),
        ("int8_", 3, dict(wire_dtype="int8")),
        ("bf16_", 3, dict(rs_dtype="bfloat16")),
        ("bucket_", 3, dict(bucket_bytes=BUCKET)),
        ("bucket_int8_", 3, dict(wire_dtype="int8", bucket_bytes=BUCKET)),
        ("ring_", 3, dict(impl="ring")),
        ("xla_", 3, dict(impl="xla")),
        ("allreduce_", 3, dict(impl="allreduce")),
        ("p2_", 2, {}),
        ("p4_", 4, {}))


def _key(k):
    """A path key as text: a dict key, or a list index."""
    return str(k.idx) if isinstance(k, jax.tree_util.SequenceKey) else k.key


def _flat(prefix, tree):
    return {prefix + "/".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def main(dst, names=None):
    cfg = get_config("qwen3-1.7b").scaled_down()
    model = build(cfg, recipe=None)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    out = _flat("init/", params)
    for tag, world, kw in RUNS:
        if names is not None and (tag or "f32") not in names:
            continue
        sync = GradSyncConfig(use_fused_kernel=False, **kw)
        losses, final = train(model, cfg, params, sync, world)
        out.update(_flat(tag + "final/", final))
        out[tag + "losses"] = np.asarray(losses, np.float64)
        print("REFERENCE OK", tag or "f32", losses)
    np.savez(dst, **out)


def train(model, cfg, params, sync, world, steps=STEPS):
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    mesh = compat.make_mesh((world,), ("data",),
                            devices=jax.devices()[:world])

    def inner(prm, opt, batch):
        return zero1_step(jax.value_and_grad(model.loss), prm, opt, batch,
                          axis_names=("data",), opt_cfg=opt_cfg, sync=sync)

    pspec = jax.tree.map(lambda _: P(), params)
    ospec = zero1_state_specs(params, world, sync, ("data",))
    pipe = for_model(cfg, seq_len=SEQ, global_batch=world)
    bspec = {k: P("data") for k in pipe.batch_at(0)}
    step = jax.jit(compat.shard_map(
        inner, mesh=mesh, in_specs=(pspec, ospec, bspec),
        out_specs=(pspec, ospec, {"loss": P(), "grad_norm": P(), "lr": P()}),
        check_vma=False))
    opt = init_zero1_state(params, world, sync)
    losses = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses, params


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2].split(",") if len(sys.argv) > 2 else None)
