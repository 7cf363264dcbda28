"""Subprocess worker: the reference's trajectories for
``test_torch_dist_train.py``, from the port's own initial weights.

Reads ``<in.npz>``: ``qwen/<path>`` and ``phi/<path>``, the port's
seed-0 initial parameters of scaled-down qwen3-1.7b and phi-3.5-MoE
(the launcher's ``--scale-down`` configs, paths ``/``-joined), and on 4
fake CPU devices runs, from them, the recipes of the reference
trajectories the port's other ZeRO-1 tests use:

* ``_torch_zero1_ref.train``: ``zero1_step`` under ``shard_map`` at
  p = 3, the exact circulant sync, seq 16, global batch 3, ``STEPS``
  steps;
* ``_torch_ep_zero1_ref.train``: the reference's ``build_zero1`` with
  ``moe_dispatch="ep"`` on a 2x2 mesh, seq 16, global batch 2, ``STEPS``
  steps.

Writes ``<out.npz>``: ``qwen/losses``, ``qwen/final/<path>``;
``phi/loss``, ``phi/grad_norm`` (steps x 4 devices) and
``phi/final/<g>/<path>`` (device g = data·2 + model).

Run: python tests/_torch_dist_ref.py <in.npz> <out.npz>
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_ep_zero1_ref as ep_ref  # noqa: E402  (sets XLA_FLAGS)
import _torch_zero1_ref as z1_ref  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import ShardingRecipe, build  # noqa: E402
from repro.optim.zero1 import GradSyncConfig  # noqa: E402

STEPS = 3


def _load(inp, prefix, template):
    """``template``'s tree with every leaf read from ``inp``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(
            inp[prefix + "/".join(z1_ref._key(k) for k in path)],
            leaf.dtype), template)


def main(src, dst):
    inp = np.load(src)
    out = {}
    cfg = get_config("qwen3-1.7b").scaled_down()
    model = build(cfg, recipe=None)
    params = _load(inp, "qwen/", jax.eval_shape(model.init,
                                               jax.random.PRNGKey(0)))
    losses, final = z1_ref.train(model, cfg, params,
                                 GradSyncConfig(use_fused_kernel=False), 3,
                                 steps=STEPS)
    out.update(z1_ref._flat("qwen/final/", final))
    out["qwen/losses"] = np.asarray(losses, np.float64)
    print("REFERENCE OK qwen", losses)

    cfg = dataclasses.replace(
        get_config("phi3.5-moe-42b-a6.6b").scaled_down(), moe_dispatch="ep")
    mesh = compat.make_mesh((ep_ref.D, ep_ref.M), ("data", "model"),
                            devices=jax.devices()[:ep_ref.D * ep_ref.M])
    recipe = ShardingRecipe(data_axes=("data",), model_axis="model")
    model = build(cfg, recipe=recipe)
    params = _load(inp, "phi/", jax.eval_shape(model.init,
                                              jax.random.PRNGKey(0)))
    ep_ref.STEPS = STEPS  # the recipe's step count and schedule length
    out.update(ep_ref.train(cfg, model, mesh, recipe,
                            GradSyncConfig(use_fused_kernel=False), params,
                            "phi/"))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
