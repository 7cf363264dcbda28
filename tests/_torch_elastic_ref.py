"""Subprocess worker: the reference's first step after an elastic resize,
for the port's drill parity test (``test_torch_ft.py``).

Reads ``<in.json>``: a list of runs, each ``{"tag", "ckpt_dir", "step",
"world", "new_world", "wire_dtype", "steps", "lr", "warmup",
"global_batch", "seq_len"}``: a checkpoint the port's drill wrote at
``world`` ranks.  Per run it restores that checkpoint with the
reference's ``CheckpointManager`` (the port writes the reference's
layout), rebuilds the reference's global ``Zero1State`` at ``world``,
resizes it to ``new_world`` with the reference's ``resize_zero1_state``
and takes ONE ``zero1_step`` at the checkpoint's step, driven directly
under ``repro.compat.shard_map`` on a ``("data",)`` mesh of
``new_world`` of 4 fake CPU devices (``recipe=None``,
``check_vma=False``: the recipe of ``_torch_zero1_ref.py``; the
reference's drill launcher does not run on JAX 0.9).  Writes
``<out.npz>``: ``<tag>/loss`` and ``<tag>/<path>`` for every parameter
after that step.

Run: python tests/_torch_elastic_ref.py <in.json> <out.npz>
"""
import json
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
from repro.checkpoint import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import for_model  # noqa: E402
from repro.models import build  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.optim.zero1 import (GradSyncConfig, init_zero1_state,  # noqa: E402
                               resize_zero1_state, zero1_state_specs,
                               zero1_step)


def one_step(run, model, cfg):
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    step, params, opt_arrs, man = CheckpointManager(
        run["ckpt_dir"]).restore(run["step"], template)
    assert step == run["step"] and man["world"] == run["world"], man
    params = jax.tree.map(jnp.asarray, params)
    sync = GradSyncConfig(use_fused_kernel=False,
                          wire_dtype=run["wire_dtype"])
    treedef = jax.tree.structure(init_zero1_state(params, run["world"],
                                                  sync))
    state = jax.tree.unflatten(treedef, [
        np.asarray(opt_arrs[f"leaf_{i}"]) for i in range(treedef.num_leaves)])
    world = run["new_world"]
    state = resize_zero1_state(state, params, world, sync)
    opt_cfg = AdamWConfig(lr=run["lr"], warmup_steps=run["warmup"],
                          total_steps=run["steps"])
    mesh = compat.make_mesh((world,), ("data",),
                            devices=jax.devices()[:world])

    def inner(prm, opt, batch):
        return zero1_step(jax.value_and_grad(model.loss), prm, opt, batch,
                          axis_names=("data",), opt_cfg=opt_cfg, sync=sync)

    pspec = jax.tree.map(lambda _: P(), params)
    ospec = zero1_state_specs(params, world, sync, ("data",))
    bspec = {"tokens": P("data"), "targets": P("data")}
    fn = jax.jit(compat.shard_map(
        inner, mesh=mesh, in_specs=(pspec, ospec, bspec),
        out_specs=(pspec, ospec, {"loss": P(), "grad_norm": P(), "lr": P()}),
        check_vma=False))
    pipe = for_model(cfg, seq_len=run["seq_len"],
                     global_batch=run["global_batch"])
    batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(step).items()}
    params, _, metrics = fn(params, jax.tree.map(jnp.asarray, state), batch)
    out = {f"{run['tag']}/loss": np.asarray(float(metrics["loss"]))}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[run["tag"] + "/" + "/".join(k.key for k in path)] = \
            np.asarray(leaf)
    return out


def main(src, dst):
    with open(src) as f:
        runs = json.load(f)
    cfg = get_config("qwen3-1.7b").scaled_down()
    model = build(cfg, recipe=None)
    out = {}
    for run in runs:
        out.update(one_step(run, model, cfg))
        print("REFERENCE OK", run["tag"], float(out[f"{run['tag']}/loss"]))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
