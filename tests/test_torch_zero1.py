"""The port's ZeRO-1 training against the reference's.

The reference's ``zero1_step`` is driven directly under
``repro.compat.shard_map`` on 3 fake CPU devices (subprocess worker
``_torch_zero1_ref.py``); its initial weights are carried into the port
with ``repro_torch.convert``, and the port trains the same 4 steps at
p = 3 on a ``LocalComm``, with the fused round on (its plain version on
the CPU) and off.

Tolerances: per-step losses within 1e-5 absolute and parameters after
step 4 within ``rtol=1e-5``.  The reduce-scatter folds are bitwise equal
to the reference's (``test_torch_collectives.py``), but the gradients
come from different float32 matmul and reduction orders (CPU torch vs
XLA), tiny leaves go through an all-reduce whose summation order the
reference does not pin, and AdamW divides by ``sqrt(v)``.  ``atol=1e-9``
covers the few parameters that sit within ~1e-5 of zero, where an
update's last-bit difference is a large relative one (observed: 1 of
8192 elements, 1.7e-10 apart).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.comm import LocalComm
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import bootstrap
from repro_torch.optim.zero1 import (GradSyncConfig, init_zero1_state,
                                     is_zero_leaf, local_rows)

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 4


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero1") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable,
                           os.path.join(HERE, "_torch_zero1_ref.py"), str(out)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    z = np.load(out)

    def tree(prefix):
        return T.unflatten((tuple(k[len(prefix):].split("/")), z[k])
                           for k in z.files if k.startswith(prefix))

    return tree("init/"), z["losses"], tree("final/")


def _train(init, mode, fused=None):
    dp = 3 if mode == "zero1" else 1
    sess = bootstrap.build_session(
        arch="qwen3-1.7b", scale_down=True, steps=STEPS, seq_len=16,
        global_batch=3, dp=dp, mode=mode, use_fused_kernel=fused,
        device="cpu", init_state=False)
    params = params_from_numpy(init, sess.cfg)
    sess.params = ([params] + [T.map_leaves(torch.clone, params)
                               for _ in range(dp - 1)]
                   if mode == "zero1" else params)
    sess.opt = sess.built.init_opt(sess.params)
    losses = [float(bootstrap.run_step(sess, s)["loss"])
              for s in range(STEPS)]
    return sess, losses


def _assert_params_close(got: dict, want: dict):
    for (path, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9,
                                   err_msg=".".join(path))


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_zero1_trajectory_matches_reference(reference, fused):
    init, ref_losses, ref_final = reference
    sess, losses = _train(init, "zero1", fused)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    finals = [params_to_numpy(p) for p in sess.params]
    for final in finals:
        _assert_params_close(final, ref_final)
    for final in finals[1:]:  # the allgather replicates bitwise
        for a, b in zip(T.leaves(final), T.leaves(finals[0])):
            np.testing.assert_array_equal(a, b)
    # ceil(log2 3) = 2 exchanges per RS and per AG, per zero leaf per step
    n_zero = sum(is_zero_leaf(a.shape, 3, 1024) for a in T.leaves(init))
    assert sess.comm.exchanges == STEPS * n_zero * 2 * 2


def test_zero1_equals_single(reference):
    """Within the port, ZeRO-1 at p = 3 trains like one rank on the whole
    batch (same tolerance: only summation orders differ)."""
    init, _, _ = reference
    z1, z_losses = _train(init, "zero1", False)
    single, s_losses = _train(init, "single")
    np.testing.assert_allclose(z_losses, s_losses, rtol=0, atol=1e-5)
    _assert_params_close(params_to_numpy(z1.params[0]),
                         params_to_numpy(single.params))


def test_zero1_state_is_sharded():
    sync = GradSyncConfig()
    params = {"big": torch.zeros(28, 64), "tiny": torch.zeros(5)}
    st = init_zero1_state(params, 3, sync)
    assert tuple(st.m["big"].shape) == (10, 64)   # ceil(28 / 3) rows
    assert tuple(st.m["tiny"].shape) == (5,)
    x = torch.arange(28.0)[:, None]
    shards = [local_rows(x, r, 3) for r in range(3)]
    assert torch.equal(torch.cat(shards)[:28], x)
    assert torch.equal(shards[2][8:], torch.zeros(2, 1))  # padding rows


@pytest.mark.parametrize("kw,err", [
    (dict(wire_dtype="int8"), NotImplementedError),
    (dict(compress="int8"), TypeError),      # comes with the int8 wire
    (dict(bucket_bytes=1 << 20), NotImplementedError),
    (dict(impl="ring"), NotImplementedError)])
def test_unported_sync_fields_raise(kw, err):
    with pytest.raises(err):
        GradSyncConfig(**kw)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        bootstrap.build_session(arch="qwen3-1.7b", scale_down=True, dp=3,
                                global_batch=3, device="cuda")
    assert LocalComm(3).p == 3
