"""Subprocess worker: the reference's tensor-parallel training for the
port's parity tests (``test_torch_tp.py``, ``test_torch_fsdp.py``,
``test_torch_tp_moe.py``, ``test_torch_tp_vlm.py``, and the hybrid's,
the xLSTM's and the encoder-decoder's ``test_torch_tp_*.py``).

The reference's own step builders, ``repro.train.steps.build("zero1" |
"fsdp_auto", ...)`` with a ``ShardingRecipe``, run on a plain
``jax.sharding.Mesh`` of 4 fake CPU devices, ``(data, model)`` = (2, 2)
or (1, 4), inside ``with mesh:`` (what fails on JAX 0.9 is the Explicit
axis ``repro.compat.make_mesh`` builds, not the step).  fsdp_auto's
parameters are placed by the model's sanitized ``param_specs``, its
batch by ``P("data")``.  Scaled-down qwen3-1.7b and qwen1.5-110b (its
QKV bias; fsdp_auto trains it ``tp_fsdp``, as the reference's dry run
does), phi-3.5-MoE (global and rowwise dispatch), grok-1-314b and
llama-3.2-vision-90b (both ``tp_fsdp`` under fsdp_auto; the VLM's batch
holds its image embeddings), hymba-1.5b, xlstm-125m and whisper-small
(``tp`` under fsdp_auto; whisper's batch holds its frames; a run's
``<arch>~<tag>`` is the scaled-down config with :data:`MODELS`'
fields), seq 16, global batch 4, the launcher's
AdamW defaults, the
circulant sync on the jnp backend, 4 steps from the initial parameters
in ``<in.npz>`` (``<arch>/<path>``: the port's launcher's seed-0
draw).  Writes ``<out.npz>``: ``<arch>/init/<path>``, and
per run (:data:`RUNS`, or those named) ``<run>/losses``,
``<run>/gnorms`` and ``<run>/final/<path>``.  Each run compiles its own
step (~6-12 s), so each test file asks for its own few.

Run: python tests/_torch_tp_ref.py <in.npz> <out.npz> [run,run,...]
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
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data import for_model  # noqa: E402
from repro.launch.mesh import sanitize_specs  # noqa: E402
from repro.models import ShardingRecipe, build  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.optim.zero1 import GradSyncConfig  # noqa: E402
from repro.train.steps import build as build_step  # noqa: E402

STEPS, SEQ, BATCH = 4, 16, 4
#: run -> (arch, mode, mesh shape, recipe kwargs, GradSyncConfig kwargs
#: [, config overrides])
RUNS = {
    "zero1_2x2": ("qwen3-1.7b", "zero1", (2, 2), {}, {}),
    "zero1_1x4_gqa": ("qwen3-1.7b", "zero1", (1, 4),
                      dict(tp_size=4, expand_gqa=True), {}),
    "zero1_2x2_int8": ("qwen3-1.7b", "zero1", (2, 2), {},
                       dict(wire_dtype="int8")),
    "fsdp_2x2_tp_fsdp": ("qwen1.5-110b", "fsdp_auto", (2, 2),
                         dict(mode="tp_fsdp"), {}),
    "fsdp_1x4_tp_fsdp": ("qwen1.5-110b", "fsdp_auto", (1, 4),
                         dict(mode="tp_fsdp", sequence_parallel=True), {}),
    # the MoE family (``test_torch_tp_moe.py``): global dispatch, then
    # rowwise (the config's ``moe_dispatch``, a sixth entry)
    "moe_zero1_2x2": ("phi3.5-moe-42b-a6.6b", "zero1", (2, 2), {}, {}),
    "moe_zero1_1x4_sp": ("phi3.5-moe-42b-a6.6b", "zero1", (1, 4),
                         dict(sequence_parallel=True), {}),
    "moe_zero1_2x2_rowwise": ("phi3.5-moe-42b-a6.6b", "zero1", (2, 2), {},
                              {}, dict(moe_dispatch="rowwise")),
    "grok_fsdp_2x2": ("grok-1-314b", "fsdp_auto", (2, 2),
                      dict(mode="tp_fsdp"), {}),
    # the VLM family (``test_torch_tp_vlm.py``)
    "vlm_zero1_2x2": ("llama-3.2-vision-90b", "zero1", (2, 2), {}, {}),
    "vlm_fsdp_2x2": ("llama-3.2-vision-90b", "fsdp_auto", (2, 2),
                     dict(mode="tp_fsdp"), {}),
    # the hybrid (``test_torch_tp_hybrid.py``): heads and vocab that do
    # not divide the axis (``sanitize_spec`` relocates them onto
    # d_model, as at full width), then sequence-parallel
    "hybrid_zero1_2x2": ("hymba-1.5b~relocated", "zero1", (2, 2), {}, {}),
    "hybrid_zero1_1x4_sp": ("hymba-1.5b", "zero1", (1, 4),
                            dict(sequence_parallel=True), {}),
    # the xLSTM (``test_torch_tp_xlstm.py``) and the encoder-decoder
    # (``test_torch_tp_encdec.py``; whisper-small is not in
    # ``FSDP_ARCHS``: fsdp_auto trains recipe mode ``tp``)
    "xlstm_zero1_2x2": ("xlstm-125m", "zero1", (2, 2), {}, {}),
    "encdec_fsdp_2x2": ("whisper-small", "fsdp_auto", (2, 2), {}, {}),
}
#: ``<arch>~<tag>``: the scaled-down config with these fields overridden
#: (``_torch_tp_cases.MODELS``, the port's side, holds them too)
MODELS = {"hymba-1.5b~relocated": dict(n_heads=5, n_kv_heads=5,
                                       vocab_size=129)}


def config(model, **kw):
    """The scaled-down config of ``model`` (an arch, or ``<arch>~<tag>``
    of :data:`MODELS`), with ``kw`` overridden too."""
    return get_config(model.split("~")[0]).scaled_down(
        **MODELS.get(model, {}), **kw)


def _key(k):
    return str(k.idx) if isinstance(k, jax.tree_util.SequenceKey) else k.key


def _flat(prefix, tree):
    return {prefix + "/".join(_key(k) for k in path):
            np.asarray(jax.device_get(leaf), np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def train(arch, mode, shape, recipe_kw, sync_kw, init, cfg_kw=None):
    cfg = config(arch, **(cfg_kw or {}))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape),
                ("data", "model"))
    recipe = ShardingRecipe(data_axes=("data",), model_axis="model",
                            **recipe_kw)
    model = build(cfg, recipe=recipe)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=STEPS)
    sync = GradSyncConfig(use_fused_kernel=False, **sync_kw)
    pipe = for_model(cfg, seq_len=SEQ, global_batch=BATCH)
    with mesh:
        built = build_step(mode, model, opt_cfg, mesh=mesh, recipe=recipe,
                           sync=sync)
        params = jax.tree.map(jnp.asarray, init)
        if mode == "fsdp_auto":
            specs = sanitize_specs(mesh, model.param_specs(params), params)
            params = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                params, specs, is_leaf=lambda x: isinstance(x, P))
        opt = built.init_opt(params)
        if mode == "zero1":
            opt = jax.device_put(opt, built.opt_spec(params))
        losses, gnorms = [], []
        for s in range(STEPS):
            batch = {k: jax.device_put(jnp.asarray(v),
                                       NamedSharding(mesh, P("data")))
                     for k, v in pipe.batch_at(s).items()}
            params, opt, metrics = built.step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
    return losses, gnorms, params


def _load(src, arch):
    """``<arch>/<path>`` of ``src`` as the reference's parameter tree,
    each leaf in the config's dtype."""
    cfg = config(arch)
    like = jax.eval_shape(build(cfg).init, jax.random.PRNGKey(0))
    z = np.load(src)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            z[arch + "/" + "/".join(_key(k) for k in path)], a.dtype), like)


def main(src, dst, names):
    runs = {n: RUNS[n] for n in names}
    out, inits = {}, {}
    for arch in sorted({r[0] for r in runs.values()}):
        inits[arch] = _load(src, arch)
        out.update(_flat(f"{arch}/init/", inits[arch]))
    for name, (arch, mode, shape, rkw, skw, *ckw) in runs.items():
        losses, gnorms, final = train(arch, mode, shape, rkw, skw,
                                      inits[arch], *ckw)
        out[f"{name}/losses"] = np.asarray(losses, np.float64)
        out[f"{name}/gnorms"] = np.asarray(gnorms, np.float64)
        out.update(_flat(f"{name}/final/", final))
        print("REFERENCE OK", name, losses, flush=True)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3].split(",")
         if len(sys.argv) > 3 else list(RUNS))
