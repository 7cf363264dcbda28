"""Subprocess worker: the reference's zero1 + expert-parallel MoE
trajectory for the port's parity test (``test_torch_ep_zero1.py``).

Builds the reference's own zero1 step (``repro.train.build("zero1",
...)``, i.e. ``build_zero1``) for phi-3.5-MoE scaled down with
``moe_dispatch="ep"`` on a ``(2, 2)`` ``("data", "model")`` mesh of fake
CPU devices, as ``tests/_a2a_checks.py`` does, and trains 4 steps (seq
16, global batch 2, the launcher's AdamW defaults, circulant halving sync
on the jnp backend).  The step runs fully manual: every device holds
whole replicas, and its parameters after a step are its own.  Writes
``<out.npz>``: the initial parameters (``init/<path>``), the per-step
metrics of every device (``loss``, ``grad_norm``: ``(steps, 4)``), and
every device's parameters after the last step (``final/<g>/<path>``,
device g = data·2 + model); the same again with the bucketed, pipelined
sync over the data axis (``bucket_bytes=BUCKET``), prefixed ``bucket_``.

Run: python tests/_torch_ep_zero1_ref.py <out.npz>
"""
import dataclasses
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

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import for_model  # noqa: E402
from repro.models import ShardingRecipe, build  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.optim.zero1 import GradSyncConfig  # noqa: E402
from repro.train import build as build_step  # noqa: E402

STEPS, SEQ, BATCH, D, M = 4, 16, 2, 2, 2
#: the bucketed run's bucket size (= test_torch_ep_zero1.BUCKET).
BUCKET = 30_000


def _path(path):
    return "/".join(k.key for k in path)


def per_device(arr, mesh):
    """Each device's buffer of ``arr``, by its data-major mesh rank."""
    pos = {dev.id: i for i, dev in enumerate(mesh.devices.flat)}
    out = [None] * mesh.devices.size
    for shard in arr.addressable_shards:
        out[pos[shard.device.id]] = np.asarray(shard.data)
    return out


def main(dst):
    cfg = dataclasses.replace(
        get_config("phi3.5-moe-42b-a6.6b").scaled_down(), moe_dispatch="ep")
    mesh = compat.make_mesh((D, M), ("data", "model"),
                            devices=jax.devices()[:D * M])
    recipe = ShardingRecipe(data_axes=("data",), model_axis="model")
    model = build(cfg, recipe=recipe)
    init = model.init(jax.random.PRNGKey(0))
    out = {"init/" + _path(p): np.asarray(leaf) for p, leaf in
           jax.tree_util.tree_flatten_with_path(init)[0]}
    for pre, bucket in (("", None), ("bucket_", BUCKET)):
        sync = GradSyncConfig(use_fused_kernel=False, bucket_bytes=bucket)
        out.update(train(cfg, model, mesh, recipe, sync, init, pre))
    np.savez(dst, **out)


def train(cfg, model, mesh, recipe, sync, params, pre):
    built = build_step("zero1", model,
                       AdamWConfig(lr=3e-4, warmup_steps=20,
                                   total_steps=STEPS),
                       mesh=mesh, recipe=recipe, sync=sync)
    out = {}
    opt = jax.device_put(built.init_opt(params), built.opt_spec(params))
    pipe = for_model(cfg, seq_len=SEQ, global_batch=BATCH)
    losses, gnorms = [], []
    with compat.use_mesh(mesh):
        for s in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
            params, opt, metrics = built.step_fn(params, opt, batch)
            losses.append([float(v) for v in per_device(metrics["loss"],
                                                        mesh)])
            gnorms.append([float(v) for v in per_device(
                metrics["grad_norm"], mesh)])
    for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        for g, a in enumerate(per_device(leaf, mesh)):
            out[f"{pre}final/{g}/{_path(p)}"] = a
    out[pre + "loss"] = np.asarray(losses, np.float64)
    out[pre + "grad_norm"] = np.asarray(gnorms, np.float64)
    print("REFERENCE OK", pre, losses, gnorms)
    return out


if __name__ == "__main__":
    main(sys.argv[1])
