"""Shared by ``test_torch_tp_ckpt.py`` and ``test_torch_tp_reshard.py``:
the port's sessions on a model axis, their checkpoints, and the spawn of
``_torch_ckpt_ref.py`` (the reference's side).

Every run starts from the launcher's seed-0 parameters (scaled down:
qwen3-1.7b, qwen1.5-110b, phi-3.5-MoE with ``moe_dispatch="ep"``),
seq 16, global batch 4, the launcher's AdamW defaults and ``--steps
4`` (the learning-rate schedule's length); a checkpoint is written after
:data:`K` steps.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from _torch_tp_cases import BK_ATOL
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import to_host
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import bootstrap
from repro_torch.models import param_shapes
from repro_torch.optim.zero1 import Zero1State, resize_zero1_state

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL, SEQ, BATCH, K = 4, 16, 4, 2
MOE = "phi3.5-moe-42b-a6.6b"
#: run -> (model, mode, (D, M), recipe kwargs, sync kwargs): the
#: reference's task fields (``_torch_ckpt_ref.py``)
RUNS = {"zero1": ("qwen3-1.7b", "zero1", (2, 2), {}, {}),
        "int8": ("qwen3-1.7b", "zero1", (2, 2), {}, dict(wire_dtype="int8")),
        "fsdp": ("qwen1.5-110b", "fsdp_auto", (2, 2), dict(mode="tp_fsdp"),
                 {}),
        "ep": (MOE + "~ep", "zero1", (2, 2), {}, {})}


def session(model: str, mode: str, shape, sync=None, init_state=False,
            **kw):
    """The port's launcher session of ``model`` (``<arch>`` or
    ``<arch>~ep``) on a ``shape`` mesh in ``mode``, no state yet."""
    arch, _, tag = model.partition("~")
    if tag == "ep":
        kw["moe_dispatch"] = "ep"
    return bootstrap.build_session(
        arch=arch, scale_down=True, steps=kw.pop("steps", TOTAL),
        seq_len=SEQ, global_batch=kw.pop("batch", BATCH), dp=shape[0],
        mp=shape[1], mode=mode, device="cpu", init_state=init_state,
        **(sync or {}), **kw)


def init_numpy(model: str) -> dict:
    """The launcher's seed-0 parameters of ``model``, numpy, whole."""
    sess = session(model, "single" if "~" not in model else "zero1",
                   (1, 1) if "~" not in model else (2, 2))
    return params_to_numpy(sess.model.init(torch.Generator().manual_seed(0),
                                           torch.device("cpu")))


def start(sess, init: dict):
    """Put ``init`` (numpy, whole) into ``sess`` as every rank's state."""
    full = params_from_numpy(init, sess.cfg)
    sess.params = (bootstrap.shard_params(sess, full) if sess.tp is not None
                   else [full] + [T.map_leaves(torch.clone, full)
                                  for _ in sess.comm.ranks[1:]])
    sess.opt = sess.built.init_opt(sess.params)
    return sess


def save(sess, ckpt_dir: str, step: int) -> CheckpointManager:
    """``sess``'s state written as the launcher writes it."""
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(step, bootstrap.params_whole(sess), bootstrap.opt_flat(sess),
             {"data_cursor": step, "world": sess.world})
    return mgr


def arrays(sess) -> dict:
    """``sess``'s state as a checkpoint's ``arrays.npz`` holds it."""
    out = {f"p_{i}": to_host(x)
           for i, x in enumerate(T.leaves(bootstrap.params_whole(sess)))}
    out.update({f"opt_{k}": to_host(v)
                for k, v in bootstrap.opt_flat(sess).items()})
    return out


def read(ckpt_dir: str, step: int) -> dict:
    return dict(np.load(os.path.join(ckpt_dir, f"step_{step}",
                                     "arrays.npz")))


def resized(z: dict, sess, world: int) -> dict:
    """A checkpoint's arrays (written at data world ``world``) as a zero1
    session of ``sess``'s data world holds them: the moments and EF
    through ``resize_zero1_state`` (bitwise the reference's,
    ``test_torch_ft_state.py``), the rest as they are."""
    if sess.mode != "zero1" or sess.world == world:
        return z
    shapes = T.flatten(param_shapes(sess.cfg))
    paths, n = [p for p, _ in shapes], len(shapes)
    opt = [z[f"opt_leaf_{i}"] for i in range(sum(
        k.startswith("opt_") for k in z))]

    def tree(lo):
        return T.unflatten(zip(paths, opt[lo:lo + n]))

    st = resize_zero1_state(
        Zero1State(m=tree(0), v=tree(n), step=int(opt[2 * n]),
                   ef=tree(2 * n + 1) if len(opt) > 2 * n + 1 else None),
        T.unflatten((p, np.zeros(s, np.float32)) for p, s in shapes),
        sess.world, sess.sync)
    new = (T.leaves(st.m) + T.leaves(st.v) + [opt[2 * n]]
           + (T.leaves(st.ef) if st.ef is not None else []))
    out = dict(z)
    out.update({f"opt_leaf_{i}": np.asarray(a) for i, a in enumerate(new)})
    return out


def assert_same_bytes(got: dict, want: dict) -> None:
    """The same keys, and every array the same shape, dtype and bytes."""
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (k, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), k


def reference(tmp, tasks: list, models) -> dict:
    """Spawn ``_torch_ckpt_ref.py`` on ``tasks`` (the initial parameters of
    ``models`` written for it); its npz as a dict."""
    inits = {}
    for model in models:
        for path, leaf in T.flatten(init_numpy(model)):
            inits[f"{model}/" + "/".join(map(str, path))] = leaf
    np.savez(tmp / "in.npz", **inits)
    with open(tmp / "in.json", "w") as f:
        json.dump(tasks, f)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_ckpt_ref.py"),
         str(tmp / "in.json"), str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(tmp / "out.npz"))


def task(run: str, kind: str, tag: str, **kw) -> dict:
    """A reference task of ``run``'s model, mode, mesh and sync."""
    model, mode, shape, recipe, sync = RUNS[run]
    return dict(dict(kind=kind, tag=tag, model=model, mode=mode,
                     shape=list(shape), recipe=recipe, sync=sync,
                     total_steps=TOTAL, batch=BATCH), **kw)


def assert_params_close(got: dict, want: dict, atol: float) -> None:
    """Whole parameter trees (numpy) within ``rtol=1e-5`` / ``atol``, QKV
    bias's ``bk`` within ``_torch_tp_cases.BK_ATOL`` (its docstring says
    why), as ``test_torch_tp.py`` holds them."""
    assert [p for p, _ in T.flatten(got)] == [p for p, _ in T.flatten(want)]
    for (path, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
        np.testing.assert_allclose(
            a, b, rtol=1e-5,
            atol=max(atol, BK_ATOL) if path[-1] == "bk" else atol,
            err_msg=".".join(map(str, path)))


def leaves_of(z: dict, prefix: str) -> dict:
    """``leaf_<i>`` arrays of ``z`` under ``prefix``, keyed ``leaf_<i>``."""
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def ref_tree(z: dict, prefix: str) -> dict:
    return T.unflatten((tuple(int(x) if x.isdigit() else x
                              for x in k[len(prefix):].split("/")), v)
                       for k, v in z.items() if k.startswith(prefix))
