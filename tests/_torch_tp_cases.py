"""Shared by ``test_torch_tp.py``, ``test_torch_fsdp.py`` and the
families' ``test_torch_tp_*.py``: the runs of ``_torch_tp_ref.py`` on
the port's side, the reference worker's spawn, and the holds the files
make.

Every run starts from the launcher's seed-0 parameters (scaled-down
qwen3-1.7b, qwen1.5-110b for its QKV bias, phi-3.5-MoE, grok-1-314b,
llama-3.2-vision-90b, hymba-1.5b, xlstm-125m and whisper-small),
carried to the reference with ``repro_torch.convert``, so the
launcher's own CLI runs are held against the reference's runs too.  A
run's ``model`` (``<arch>~<tag>``) overrides fields of the scaled-down
config on both sides (:data:`MODELS`); the launcher has no flag for
that, so :func:`session` builds it under :class:`configured`.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import bootstrap
from repro_torch.models import build, value_and_grad, value_and_grad_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, SEQ, BATCH = 4, 16, 4
MOE, GROK, VLM = "phi3.5-moe-42b-a6.6b", "grok-1-314b", "llama-3.2-vision-90b"
HYBRID, XLSTM, ENCDEC = "hymba-1.5b", "xlstm-125m", "whisper-small"
#: run -> the port's ``build_session`` kwargs (the runs of
#: ``_torch_tp_ref.RUNS`` and two layouts held by their gradients only)
RUNS = {
    "zero1_2x2": dict(arch="qwen3-1.7b", mode="zero1", dp=2, mp=2),
    "zero1_1x4_sp": dict(arch="qwen3-1.7b", mode="zero1", dp=1, mp=4,
                         sequence_parallel=True),
    "zero1_1x4_gqa": dict(arch="qwen3-1.7b", mode="zero1", dp=1, mp=4,
                          expand_gqa=True),
    "zero1_2x2_int8": dict(arch="qwen3-1.7b", mode="zero1", dp=2, mp=2,
                           wire_dtype="int8"),
    "zero1_2x2_bias": dict(arch="qwen1.5-110b", mode="zero1", dp=2, mp=2),
    "fsdp_2x2_tp_fsdp": dict(arch="qwen1.5-110b", mode="fsdp_auto", dp=2,
                             mp=2),
    "fsdp_1x4_tp_fsdp": dict(arch="qwen1.5-110b", mode="fsdp_auto", dp=1,
                             mp=4, sequence_parallel=True),
    "moe_zero1_2x2": dict(arch=MOE, mode="zero1", dp=2, mp=2),
    "moe_zero1_1x4_sp": dict(arch=MOE, mode="zero1", dp=1, mp=4,
                             sequence_parallel=True),
    "moe_zero1_2x2_rowwise": dict(arch=MOE, mode="zero1", dp=2, mp=2,
                                  moe_dispatch="rowwise"),
    "grok_fsdp_2x2": dict(arch=GROK, mode="fsdp_auto", dp=2, mp=2),
    "grok_fsdp_1x4_sp": dict(arch=GROK, mode="fsdp_auto", dp=1, mp=4,
                             sequence_parallel=True),
    "vlm_zero1_2x2": dict(arch=VLM, mode="zero1", dp=2, mp=2),
    "vlm_zero1_1x4_sp": dict(arch=VLM, mode="zero1", dp=1, mp=4,
                             sequence_parallel=True),
    "vlm_fsdp_2x2": dict(arch=VLM, mode="fsdp_auto", dp=2, mp=2),
    "hybrid_zero1_2x2": dict(arch=HYBRID, mode="zero1", dp=2, mp=2,
                             model=HYBRID + "~relocated"),
    "hybrid_zero1_1x4_sp": dict(arch=HYBRID, mode="zero1", dp=1, mp=4,
                                sequence_parallel=True),
    "hybrid_fsdp_2x2": dict(arch=HYBRID, mode="fsdp_auto", dp=2, mp=2),
    "xlstm_zero1_2x2": dict(arch=XLSTM, mode="zero1", dp=2, mp=2),
    "xlstm_fsdp_1x4_sp": dict(arch=XLSTM, mode="fsdp_auto", dp=1, mp=4,
                              sequence_parallel=True),
    "encdec_zero1_2x2": dict(arch=ENCDEC, mode="zero1", dp=2, mp=2,
                             model=ENCDEC + "~v129"),
    "encdec_fsdp_2x2": dict(arch=ENCDEC, mode="fsdp_auto", dp=2, mp=2),
    "encdec_zero1_1x4_sp": dict(arch=ENCDEC, mode="zero1", dp=1, mp=4,
                                sequence_parallel=True),
}
#: ``<arch>~<tag>`` -> the fields overridden in the scaled-down config
#: (``_torch_tp_ref.MODELS`` holds those of its runs): hymba with heads,
#: kv heads and vocab that divide neither 2 nor 4, as at full width (25,
#: 5, 32001), so ``sanitize_spec`` relocates the attention, the
#: embedding and the head onto d_model; whisper with such a vocab (51865
#: at full width)
MODELS = {HYBRID + "~relocated": dict(n_heads=5, n_kv_heads=5,
                                      vocab_size=129),
          ENCDEC + "~v129": dict(vocab_size=129)}


class configured:
    """Within the block, every session the launcher builds has ``model``'s
    config: its arch's scale-down with :data:`MODELS`' fields."""

    def __init__(self, model: str | None):
        self.fields = MODELS.get(model or "", {})

    def __enter__(self):
        self.resolve = resolve = bootstrap.resolve_cfg
        fields = self.fields

        def cfg(*args, **kw):
            return dataclasses.replace(resolve(*args, **kw), **fields)

        if fields:
            bootstrap.resolve_cfg = cfg

    def __exit__(self, *exc):
        bootstrap.resolve_cfg = self.resolve


def model_of(run: str) -> str:
    """The model key of ``run``: its arch, or ``<arch>~<tag>``."""
    return RUNS[run].get("model", RUNS[run]["arch"])


def init_numpy(model: str) -> dict:
    """The launcher's seed-0 initial parameters of ``model`` (an arch, or
    ``<arch>~<tag>``) scaled down, as the reference's numpy tree."""
    with configured(model):
        sess = bootstrap.build_session(
            arch=model.split("~")[0], scale_down=True, device="cpu",
            steps=1, seq_len=SEQ, global_batch=1, init_state=False)
    return params_to_numpy(sess.model.init(torch.Generator().manual_seed(0),
                                           torch.device("cpu")))


def reference(tmp, runs) -> dict:
    """Spawn ``_torch_tp_ref.py`` on the launcher's initial parameters for
    ``runs``; its npz as a dict."""
    inits = {}
    for model in sorted({model_of(r) for r in runs}):
        for path, leaf in T.flatten(init_numpy(model)):
            inits[f"{model}/" + "/".join(map(str, path))] = leaf
    np.savez(tmp / "in.npz", **inits)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_tp_ref.py"),
         str(tmp / "in.npz"), str(tmp / "ref.npz"), ",".join(runs)],
        capture_output=True, text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(tmp / "ref.npz"))


def tree(z: dict, prefix: str) -> dict:
    """The leaves of ``z`` under ``prefix`` as a tree (the xLSTM's layer
    indices as ``int``: a list, as the port holds it)."""
    return T.unflatten((tuple(int(x) if x.isdigit() else x
                              for x in k[len(prefix):].split("/")), v)
                       for k, v in z.items() if k.startswith(prefix))


def session(run: str, steps: int = STEPS, **kw):
    """The port's session of ``run`` (no state yet)."""
    kw = {**RUNS[run], **kw}
    with configured(kw.pop("model", None)):
        return bootstrap.build_session(
            scale_down=True, steps=steps, seq_len=SEQ, global_batch=BATCH,
            device="cpu", init_state=False, **kw)


def replicas_agree(sess) -> None:
    """Every leaf not split over the model axis is the same bits on
    every model rank of a data rank."""
    lls = T.flatten(sess.tp.layout.leaves)
    by_data: dict = {}
    for tree_, d in zip(sess.params, sess.comm.ranks):
        by_data.setdefault(d, []).append(tree_)
    for trees in by_data.values():
        for path, ll in lls:
            if ll.model is None:
                first = T.get(trees[0], path)
                for t in trees[1:]:
                    assert T.same_bits(first, T.get(t, path)), path


def train(run: str, init: dict, steps: int = STEPS):
    """``run`` on the port from ``init`` (numpy, whole): ``(sess, losses,
    grad norms)``, the replicas held after every step."""
    sess = session(run, steps)
    sess.params = bootstrap.shard_params(sess,
                                         params_from_numpy(init, sess.cfg))
    sess.opt = sess.built.init_opt(sess.params)
    losses, gnorms = [], []
    for s in range(steps):
        m = bootstrap.run_step(sess, s)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        replicas_agree(sess)
    return sess, losses, gnorms


#: parameters' ``atol``: ``test_torch_zero1.py``'s 1e-9 covers its
#: near-zero elements; here one embedding element (of 8,192, at
#: |5.1e-5|, a row the batch uses, whose vocab-parallel gradient sums its
#: shards in another order) ends 1.6-2.4e-9 apart in the qwen1.5-110b
#: runs: 5e-9 is a three-thousandth of the first step's learning rate.
ATOL = 5e-9
#: ``bk``'s own ``atol``: its gradient sums the keys' gradients over the
#: positions, which nearly cancel (a query's softmax ignores a shift
#: common to its scores; only RoPE's rotation breaks it), so its smallest
#: elements sit at the float32 noise of that sum and AdamW's first
#: updates (about +-lr) take their sign from it.  Measured: 2.4-6.0e-8
#: against the reference, 1.8e-8 between the port's TP and unsharded
#: runs of the same step.
BK_ATOL = 1e-7
#: the VLM's fsdp_auto run's ``atol`` (its zero1 run holds ``ATOL``): one
#: ``self_layers.ffn.w_up`` element (of 32,768) ends 1.36e-7 from the
#: reference's.  Its step-0 gradient is -4.7e-8, near AdamW's eps (1e-8),
#: so its first update takes its size from that gradient's float32 noise:
#: the port's unsharded ``single`` run of the same global batch ends
#: 8.1e-8 from the reference's there too, and the fsdp_auto run 5.4e-8
#: from it.  2e-7 is a seventy-fifth of the first step's learning rate.
VLM_FSDP_ATOL = 2e-7


def assert_run_matches(z: dict, run: str, atol: float = ATOL,
                       loss_tol: float = 1e-5,
                       gnorm_tol: float | None = 1e-5) -> None:
    """The port's ``run`` against the reference's: losses within
    ``loss_tol`` and grad norms within ``gnorm_tol`` (``None``: not
    held), the parameters after the last step (whole) within
    ``rtol=1e-5`` and ``atol``."""
    sess, losses, gnorms = train(run, tree(z, f"{model_of(run)}/init/"))
    np.testing.assert_allclose(losses, z[f"{run}/losses"], rtol=0,
                               atol=loss_tol)
    if gnorm_tol is not None:
        np.testing.assert_allclose(gnorms, z[f"{run}/gnorms"], rtol=0,
                                   atol=gnorm_tol)
    got = bootstrap.whole_params(sess, sess.params)
    want = tree(z, f"{run}/final/")
    for path, a in T.flatten(got):
        np.testing.assert_allclose(
            a.float().numpy(), T.get(want, path), rtol=1e-5,
            atol=max(atol, BK_ATOL) if path[-1] == "bk" else atol,
            err_msg=".".join(map(str, path)))


def assert_grads_match(run: str, atol: dict | None = None) -> None:
    """One backward of the tensor-parallel model from the launcher's
    seed-0 parameters against the unsharded model's per data rank: every
    rank's block of every leaf within ``rtol=1e-4`` / ``atol=1e-6``
    (``atol`` maps a leaf's name to its own) (a
    leaf split over the data axes: the blocks of the data ranks' summed
    gradients).  Where the data ranks pool their tokens (fsdp_auto's
    global MoE dispatch) no data rank's gradient is its batch's alone:
    the yardstick is then D times the unsharded model's gradient on the
    global batch (each rank's loss holds the pool's aux loss, the step
    divides by D), and a leaf not split over the data axes is held
    summed over them."""
    sess = session(run)
    full = params_from_numpy(init_numpy(model_of(run)), sess.cfg)
    params = bootstrap.shard_params(sess, full)
    batches = bootstrap.place_batch(sess, sess.pipe.batch_at(0))
    _, grads = value_and_grad_ranks(sess.model.loss_ranks)(params, batches)
    vg = value_and_grad(build(sess.cfg).loss)
    pooled = (sess.tp.pooled and sess.cfg.is_moe
              and sess.cfg.moe_dispatch == "global")
    per_data = {}
    if pooled:
        whole = {k: torch.from_numpy(v)
                 for k, v in sess.pipe.batch_at(0).items()}
        g = vg(full, whole)[1]
        per_data = {d: T.map_leaves(lambda x: x * sess.comm.p, g)
                    for d in set(sess.comm.ranks)}
    for b, d in zip(batches, sess.comm.ranks):
        if d not in per_data:
            per_data[d] = vg(full, b)[1]
    if pooled:
        summed = per_data[0]
        by_data: dict = {}
        for j, d in enumerate(sess.comm.ranks):
            m = sess.tp.axis.comm.ranks[j]
            by_data[m] = by_data.get(m, []) + [j]
        grads = [T.unflatten(
            (path, x if T.get(sess.tp.layout.leaves, path).data is not None
             else sum(T.get(grads[i], path) for i in by_data[
                 sess.tp.axis.comm.ranks[j]]))
            for path, x in T.flatten(g)) for j, g in enumerate(grads)]
    else:
        summed = T.unflatten(
            (path, sum(T.get(g, path) for g in per_data.values()))
            for path, _ in T.flatten(full))
    want = bootstrap.shard_params(sess, summed)
    wloc = [bootstrap.shard_params(sess, per_data[d])[j]
            for j, d in enumerate(sess.comm.ranks)]
    for j, g in enumerate(grads):
        for path, x in T.flatten(g):
            ll = T.get(sess.tp.layout.leaves, path)
            w = T.get(want[j] if ll.data is not None or pooled else wloc[j],
                      path)
            torch.testing.assert_close(
                x, w, rtol=1e-4, atol=(atol or {}).get(path[-1], 1e-6),
                msg=".".join(map(str, path)))
