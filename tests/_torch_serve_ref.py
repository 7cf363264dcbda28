"""Subprocess worker: the reference's multi-device serving for
``test_torch_serve_mesh.py``.

On 4 fake CPU devices (meshes through ``repro.compat``), writes
``<out.npz>`` with:

* ``rep/...``: scaled-down qwen3-1.7b (2 layers, vocab 64, float32),
  weights from ``PRNGKey(0)`` (``rep/param/<path>``, dotted paths), pushed
  through ``ReplicaSet(replicas=3)``'s broadcast plan: the push stats
  ``rep/n_leaves``, ``rep/bytes``, ``rep/rounds``; ``rep/prompts`` (5, 8)
  from ``default_rng(0)`` and the round-robin greedy ``rep/tokens`` (5, 4);
* ``ep/...``: scaled-down phi-3.5-MoE (float32) with
  ``moe_dispatch="ep"`` on a 2-device ``("model",)`` mesh, weights from
  ``PRNGKey(1)`` (``ep/param/<path>``); ``ep/prompts`` (2, 8) from
  ``default_rng(1)``; ``ServeEngine(mesh=...)``'s greedy ``ep/tokens``
  (2, 6) and the logits each token was taken from, ``ep/logits`` (6, 2,
  vocab): the prefill's, then each decode step's; and the reference's
  ``Scheduler`` over that engine (``max_batch=2``, blocks of 8): the
  ``SCHED_NEW`` requests of ``ep/sched_prompts`` (3, 8) from
  ``default_rng(2)``, their tokens ``ep/sched_tokens_<i>``.

Run: python tests/_torch_serve_ref.py <out.npz>
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

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import build  # noqa: E402
from repro.serve import ReplicaSet, Scheduler, ServeEngine  # noqa: E402

REP_NEW, EP_NEW = 4, 6
#: new tokens of each scheduler request (3 requests, 2 slots)
SCHED_NEW = (4, 2, 3)


def flat(prefix, params):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = ".".join(k.key for k in path)
        out[f"{prefix}/param/{name}"] = np.asarray(leaf)
    return out


def replicas():
    cfg = get_config("qwen3-1.7b").scaled_down(n_layers=2, vocab_size=64)
    model = build(cfg, recipe=None, remat=False)
    params = model.init(jax.random.PRNGKey(0))
    rs = ReplicaSet(model, max_len=24, replicas=3)
    stats = rs.push_weights(params)
    prompts = np.random.default_rng(0).integers(0, 64, (5, 8)).astype(
        np.int32)
    out = flat("rep", params)
    out.update({"rep/n_leaves": stats["n_leaves"], "rep/bytes": stats["bytes"],
                "rep/rounds": stats["rounds"], "rep/prompts": prompts,
                "rep/tokens": rs.generate(prompts, REP_NEW)})
    return out


def expert_parallel():
    cfg = get_config("phi3.5-moe-42b-a6.6b").scaled_down(
        n_layers=2, vocab_size=64, moe_dispatch="ep")
    model = build(cfg, recipe=None, remat=False)
    params = model.init(jax.random.PRNGKey(1))
    mesh = compat.make_mesh((2,), (cfg.ep_axis,), devices=jax.devices()[:2])
    eng = ServeEngine(model=model, params=params, max_len=16, mesh=mesh)
    prompts = np.random.default_rng(1).integers(0, 64, (2, 8)).astype(
        np.int32)
    tokens = eng.generate(prompts, EP_NEW)
    # the logits each greedy token came from (generate's own loop)
    cache, logits = eng.prefill_fn(params, jnp.asarray(prompts), {})
    steps = []
    for i in range(EP_NEW):
        steps.append(np.asarray(logits))
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        cache, logits = eng.decode_fn(params, cache, nxt,
                                      jnp.asarray(8 + i, jnp.int32))
    out = flat("ep", params)
    out.update({"ep/prompts": prompts, "ep/tokens": tokens,
                "ep/logits": np.stack(steps)})
    sched = Scheduler(eng, max_batch=2, kv_block_size=8)
    sp = np.random.default_rng(2).integers(0, 64, (3, 8)).astype(np.int32)
    rids = [sched.submit(p, n) for p, n in zip(sp, SCHED_NEW)]
    done = sched.run()
    out["ep/sched_prompts"] = sp
    for i, rid in enumerate(rids):
        out[f"ep/sched_tokens_{i}"] = done[rid]
    return out


def main(path):
    out = replicas()
    out.update(expert_parallel())
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
