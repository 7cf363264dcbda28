"""Shared by ``test_torch_zero1.py`` and ``test_torch_zero1_sync.py``:
the spawn of ``_torch_zero1_ref.py`` for the runs a file reads, the
port's side of a run, and the holds both files make (their module
docstrings give the tolerances and why)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import bootstrap
from repro_torch.optim.zero1 import is_zero_leaf
from repro_torch.train.steps import build_zero1

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 4
#: bucket size of the bucketed runs (= _torch_zero1_ref.BUCKET).
BUCKET = 30_000


def reference(tmp, runs) -> dict:
    """Spawn ``_torch_zero1_ref.py`` for ``runs`` (prefixes, ``""`` the
    exact run): ``{"init": tree, prefix: (losses, final tree)}``."""
    out = tmp / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_zero1_ref.py"), str(out),
         ",".join(r or "f32" for r in runs)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    z = np.load(out)

    def tree(prefix):
        return T.unflatten((tuple(k[len(prefix):].split("/")), z[k])
                           for k in z.files if k.startswith(prefix))

    got = {pre: (z[pre + "losses"], tree(pre + "final/")) for pre in runs}
    got["init"] = tree("init/")
    return got


def train(init, mode, fused=None, wire=None, rs_dtype="float32", dp=None,
          arch="qwen3-1.7b", steps=STEPS, **kw):
    """The port's 4-step run from ``init`` (numpy): ``(sess, losses)``."""
    dp = dp or (3 if mode == "zero1" else 1)
    sess = bootstrap.build_session(
        arch=arch, scale_down=True, steps=steps, seq_len=16,
        global_batch=dp if mode == "zero1" else 3, dp=dp, mode=mode,
        use_fused_kernel=fused, wire_dtype=wire, device="cpu",
        init_state=False, **kw)
    if rs_dtype != sess.sync.rs_dtype:  # no launcher flag sets it
        sess.sync = dataclasses.replace(sess.sync, rs_dtype=rs_dtype)
        sess.built = build_zero1(sess.model, sess.comm, sess.opt_cfg,
                                 sess.sync, sess.device)
    params = params_from_numpy(init, sess.cfg)
    sess.params = ([params] + [T.map_leaves(torch.clone, params)
                               for _ in range(dp - 1)]
                   if mode == "zero1" else params)
    sess.opt = sess.built.init_opt(sess.params)
    losses = [float(bootstrap.run_step(sess, s)["loss"])
              for s in range(steps)]
    return sess, losses


def assert_params_close(got: dict, want: dict, atol: float = 1e-9):
    assert [p for p, _ in T.flatten(got)] == [p for p, _ in T.flatten(want)]
    for (path, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol,
                                   err_msg=".".join(map(str, path)))


def assert_run_matches(sess, losses, ref, atol=1e-9):
    """Losses within 1e-5 of the reference's, every rank's parameters
    within ``rtol=1e-5`` / ``atol``, and the ranks' copies bitwise equal
    (the allgather replicates bitwise)."""
    ref_losses, ref_final = ref
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    finals = [params_to_numpy(p) for p in sess.params]
    for final in finals:
        assert_params_close(final, ref_final, atol=atol)
    for final in finals[1:]:
        for a, b in zip(T.leaves(final), T.leaves(finals[0])):
            np.testing.assert_array_equal(a, b)


def zero_shapes(init, world):
    return [a.shape for a in T.leaves(init)
            if is_zero_leaf(a.shape, world, 1024)]
