"""Subprocess worker: the reference's side of the port's checkpoint tests
on a model axis (``test_torch_tp_ckpt.py``, ``test_torch_tp_reshard.py``).

Reads ``<in.json>``, a list of tasks, and ``<in.npz>``, the port's
launcher's seed-0 parameters (``<model>/<path>``).  The reference's own
step builders (``repro.train.steps.build``) run on a plain
``jax.sharding.Mesh`` of (up to) 4 fake CPU devices inside ``with mesh:``, as in
``_torch_tp_ref.py``; a model ``<arch>~ep`` is the scaled-down config
with ``moe_dispatch="ep"`` (zero1, the dispatch over the model axis).

* ``{"kind": "train", "tag", "model", "mode", "shape", "recipe",
  "sync", "steps", "total_steps", "batch", "lr", "warmup"}``: ``steps``
  steps from the initial parameters.  Writes ``<tag>/opt0/leaf_<i>``
  (the reference's ``launch.bootstrap.opt_flat``, ``np.asarray`` of
  every optimizer leaf, of the initial state), ``<tag>/opt/leaf_<i>``
  (of the state after the steps), ``<tag>/params/<path>``, ``<tag>/
  losses`` and ``<tag>/gnorms``; and ``<tag>/col<c>/leaf_<i>``: each
  optimizer leaf as model column ``c``'s devices hold it (the copy of
  each column, to tell which one ``np.asarray`` reads where the columns
  differ: the expert-parallel replicas).
* ``{"kind": "restore", ..., "ckpt", "step"}``: the reference's
  ``launch.bootstrap.restore_session`` of the port's checkpoint at
  ``step`` on a session of this mesh and mode (the reference's
  ``Session`` built around the step), then ONE step.  Writes
  ``<tag>/restored/leaf_<i>`` (its ``opt_flat`` right after the
  restore), ``<tag>/loss``, ``<tag>/gnorm`` and ``<tag>/params/<path>``
  after the step.

Run: python tests/_torch_ckpt_ref.py <in.json> <in.npz> <out.npz>
"""
import dataclasses
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
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.checkpoint import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import for_model  # noqa: E402
from repro.launch import bootstrap  # noqa: E402
from repro.launch.mesh import sanitize_specs  # noqa: E402
from repro.models import ShardingRecipe, build  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.optim.zero1 import GradSyncConfig  # noqa: E402
from repro.train.steps import build as build_step  # noqa: E402

SEQ = 16


def config(model):
    """The scaled-down config of ``model`` (``<arch>`` or ``<arch>~ep``)."""
    arch, _, tag = model.partition("~")
    cfg = get_config(arch).scaled_down()
    return dataclasses.replace(cfg, moe_dispatch="ep") if tag == "ep" \
        else cfg


def _key(k):
    return str(k.idx) if isinstance(k, jax.tree_util.SequenceKey) else k.key


def _flat(prefix, tree):
    return {prefix + "/".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _load(z, model):
    like = jax.eval_shape(build(config(model)).init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            z[model + "/" + "/".join(_key(k) for k in path)], a.dtype), like)


def session(task, init):
    """The reference's ``Session`` of ``task``'s mesh and mode around its
    own step builder, its state the initial one."""
    cfg = config(task["model"])
    mode = task["mode"]
    mesh = recipe = None
    if mode != "single":
        n = task["shape"][0] * task["shape"][1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(task["shape"]),
                    ("data", "model"))
        recipe = ShardingRecipe(data_axes=("data",), model_axis="model",
                                **task.get("recipe", {}))
    model = build(cfg, recipe=recipe)
    opt_cfg = AdamWConfig(lr=task.get("lr", 3e-4),
                          warmup_steps=task.get("warmup", 20),
                          total_steps=task["total_steps"])
    sync = GradSyncConfig(use_fused_kernel=False, **task.get("sync", {}))
    with (mesh if mesh is not None else _Null()):
        built = build_step(mode, model, opt_cfg, mesh=mesh, recipe=recipe,
                           sync=sync)
        sess = bootstrap.Session(
            cfg=cfg, mode=mode, mesh=mesh, recipe=recipe, model=model,
            opt_cfg=opt_cfg, sync=sync, built=built,
            pipe=for_model(cfg, seq_len=SEQ, global_batch=task["batch"]),
            world=task["shape"][0] if mode != "single" else 1)
        sess.params = place(sess, jax.tree.map(jnp.asarray, init))
        sess.opt = built.init_opt(sess.params)
        if mode == "zero1":
            sess.opt = jax.device_put(sess.opt, built.opt_spec(sess.params))
    return sess


def place(sess, params):
    """fsdp_auto's parameters on the mesh by their sanitized specs."""
    if sess.mode != "fsdp_auto":
        return params
    specs = sanitize_specs(sess.mesh, sess.model.param_specs(params), params)
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(sess.mesh, s)),
        params, specs, is_leaf=lambda x: isinstance(x, P))


def step(sess, s):
    batch = {k: jnp.asarray(v) for k, v in sess.pipe.batch_at(s).items()}
    if sess.mesh is not None:
        batch = {k: jax.device_put(v, NamedSharding(sess.mesh, P("data")))
                 for k, v in batch.items()}
    sess.params, sess.opt, metrics = sess.built.step_fn(sess.params,
                                                        sess.opt, batch)
    return float(metrics["loss"]), float(metrics["grad_norm"])


def column(arr, mesh, c):
    """``arr`` as model column ``c``'s devices hold it."""
    coord = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
    out = np.zeros(arr.shape, arr.dtype)
    for shard in arr.addressable_shards:
        if coord[shard.device.id][1] == c:
            out[shard.index] = np.asarray(shard.data)
    return out


def run(task, init):
    tag, out = task["tag"], {}
    sess = session(task, init)
    with (sess.mesh if sess.mesh is not None else _Null()):
        if task["kind"] == "train":
            for k, v in bootstrap.opt_flat(sess).items():
                out[f"{tag}/opt0/{k}"] = v
            losses, gnorms = [], []
            for s in range(task["steps"]):
                loss, gnorm = step(sess, s)
                losses.append(loss)
                gnorms.append(gnorm)
            out[f"{tag}/losses"] = np.asarray(losses, np.float64)
            out[f"{tag}/gnorms"] = np.asarray(gnorms, np.float64)
            for k, v in bootstrap.opt_flat(sess).items():
                out[f"{tag}/opt/{k}"] = v
            if sess.mesh is not None:
                for i, leaf in enumerate(jax.tree.leaves(sess.opt)):
                    if getattr(leaf, "ndim", 0):
                        for c in range(sess.mesh.shape["model"]):
                            out[f"{tag}/col{c}/leaf_{i}"] = column(
                                leaf, sess.mesh, c)
        else:
            s, _ = bootstrap.restore_session(
                sess, CheckpointManager(task["ckpt"]), step=task["step"])
            assert s == task["step"], (s, task)
            sess.params = place(sess, jax.tree.map(jnp.asarray, sess.params))
            for k, v in bootstrap.opt_flat(sess).items():
                out[f"{tag}/restored/{k}"] = v
            loss, gnorm = step(sess, s)
            out[f"{tag}/loss"] = np.asarray(loss, np.float64)
            out[f"{tag}/gnorm"] = np.asarray(gnorm, np.float64)
        out.update(_flat(f"{tag}/params/", sess.params))
    print("REFERENCE OK", tag, flush=True)
    return out


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def main(src, params, dst):
    with open(src) as f:
        tasks = json.load(f)
    z = np.load(params)
    inits, out = {}, {}
    for task in tasks:
        if task["model"] not in inits:
            inits[task["model"]] = _load(z, task["model"])
        out.update(run(task, inits[task["model"]]))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:4])
