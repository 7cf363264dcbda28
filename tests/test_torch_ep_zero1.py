"""The port's zero1 + expert-parallel MoE training against the reference's.

The reference's own zero1 step (``build_zero1`` with ``moe_dispatch="ep"``
on a ``(2, 2)`` ``("data", "model")`` mesh of fake CPU devices; subprocess
worker ``_torch_ep_zero1_ref.py``) and the port's launcher session
(``--mesh 2x2 --mode zero1 --moe-dispatch ep``: 4 virtual ranks of a
``LocalMesh``) train phi-3.5-MoE scaled down (float32, 2 layers, 4
experts) for 4 steps from the reference's initial weights.  Both run
fully manual: every rank holds whole replicas and keeps its own
parameters, zero1 syncs each model column over its data-axis group, and
the MoE dispatch exchanges over the model axis.  Every rank's parameters
after step 4 are compared with the same device's in the reference.

Tolerances: per-step losses and rank 0's grad norm within 1e-5
absolute; parameters within ``rtol=1e-5, atol=1e-9``, the dense zero1
test's (``test_torch_zero1.py``), for the same reasons: the gradients
come from different float32 matmul and reduction orders, tiny leaves go
through an all-reduce whose order the reference does not pin, and AdamW
divides by ``sqrt(v)``.

What the reference computes on the model axis, and the port with it:
model-axis ranks see the same tokens, so each expert owner receives M
identical copies of its slots and its experts' gradients are M times
one copy's, while the copies of experts a rank does not own get zero
gradient (never read).  Each model column's clip scale then comes from
its own grad norm, which differs between the columns (the reference's
per-device grad norms, compared below), so the two columns' replicas of
the shared weights drift apart by rounding.

The bucketed, pipelined sync (``bucket_bytes``) over the data axis is
held the same way against the reference's ``build_zero1`` with it, and
within the port is bitwise the per-leaf sync.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import tree as T
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import ceil_log2
from repro_torch.kernels import permute_rows
from repro_torch.launch import bootstrap
from repro_torch.optim.zero1 import is_zero_leaf

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, D, M = 4, 2, 2
#: the bucketed run's bucket size (= _torch_ep_zero1_ref.BUCKET).
BUCKET = 30_000


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep_zero1") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_ep_zero1_ref.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    z = np.load(out)

    def tree(prefix):
        return T.unflatten((tuple(k[len(prefix):].split("/")), z[k])
                           for k in z.files if k.startswith(prefix))

    return (tree("init/"), z["loss"], z["grad_norm"],
            [tree(f"final/{g}/") for g in range(D * M)],
            (z["bucket_loss"], z["bucket_grad_norm"],
             [tree(f"bucket_final/{g}/") for g in range(D * M)]))


def _session(fused, bucket_bytes=None):
    return bootstrap.build_session(
        arch="phi3.5-moe-42b-a6.6b", scale_down=True, steps=STEPS,
        seq_len=16, global_batch=2, dp=D, mp=M, mode="zero1",
        moe_dispatch="ep", use_fused_kernel=fused, device="cpu",
        init_state=False, bucket_bytes=bucket_bytes)


def _train(init, fused, bucket_bytes=None):
    sess = _session(fused, bucket_bytes)
    sess.params = [params_from_numpy(init, sess.cfg) for _ in range(D * M)]
    sess.opt = sess.built.init_opt(sess.params)
    metrics = [bootstrap.run_step(sess, s) for s in range(STEPS)]
    return sess, metrics


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_ep_zero1_trajectory_matches_reference(reference, fused):
    init, ref_loss, ref_gnorm, ref_final = reference[:4]
    sess, metrics = _train(init, fused)
    losses = [float(m["loss"]) for m in metrics]
    np.testing.assert_allclose(losses, ref_loss[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in metrics],
                               ref_gnorm[:, 0], rtol=0, atol=1e-5)
    for g, (got, want) in enumerate(zip(sess.params, ref_final)):
        for (path, a), (_, b) in zip(T.flatten(params_to_numpy(got)),
                                     T.flatten(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9,
                                       err_msg=f"rank {g} {'.'.join(path)}")


def test_ep_zero1_counts_and_model_axis(reference):
    """Exact exchange counts per step on each axis, and the model axis as
    the reference computes it: the columns' grad norms differ."""
    init, _, ref_gnorm, _ = reference[:4]
    assert not np.array_equal(ref_gnorm[:, 0], ref_gnorm[:, 1])
    sess = _session(True)
    sess.params = [params_from_numpy(init, sess.cfg) for _ in range(D * M)]
    sess.opt = sess.built.init_opt(sess.params)
    before = permute_rows.launches
    bootstrap.run_step(sess, 0)
    cfg = sess.cfg
    n_zero = sum(is_zero_leaf(tuple(leaf.shape), D,
                              sess.sync.min_shard_numel)
                 for leaf in T.leaves(sess.params[0]))
    q_data, q_model = ceil_log2(D), ceil_log2(M)
    # data axis: one RS and one AG per zero leaf
    assert sess.comm.exchanges == 2 * q_data * n_zero
    # model axis, per layer: forward alltoallv + 2 alltoalls, remat's
    # recomputation of the same, and the 2 float alltoalls' reverse
    # shifts in the backward
    assert sess.ep_comm.exchanges == cfg.n_layers * 8 * q_model
    assert permute_rows.launches == before  # plain version on the CPU


def test_ep_zero1_bucketed_matches_reference(reference):
    """``bucket_bytes`` on the 2x2 mesh: buckets over the data axis,
    held against the reference's bucketed ``build_zero1``, bitwise the
    port's per-leaf run, with one RS and one AG per bucket per step."""
    from repro_torch.optim.zero1 import plan_grad_buckets
    init = reference[0]
    ref_loss, ref_gnorm, ref_final = reference[4]
    sess, metrics = _train(init, True, BUCKET)
    np.testing.assert_allclose([float(m["loss"]) for m in metrics],
                               ref_loss[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in metrics],
                               ref_gnorm[:, 0], rtol=0, atol=1e-5)
    for g, (got, want) in enumerate(zip(sess.params, ref_final)):
        for (path, a), (_, b) in zip(T.flatten(params_to_numpy(got)),
                                     T.flatten(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9,
                                       err_msg=f"rank {g} {'.'.join(path)}")
    shapes = [tuple(leaf.shape) for leaf in T.leaves(sess.params[0])
              if is_zero_leaf(tuple(leaf.shape), D,
                              sess.sync.min_shard_numel)]
    buckets = plan_grad_buckets(shapes, D, BUCKET)
    leaves = [[li for li, _, _ in b] for b in buckets]
    assert max(map(len, leaves)) > 1  # a bucket holds several leaves
    assert len({li for b in leaves for li in b}) < sum(map(len, leaves))
    assert sess.comm.exchanges == STEPS * len(buckets) * 2 * ceil_log2(D)
    one, _ = _train(init, True)
    for a, b in zip(sess.params, one.params):
        for x, y in zip(T.leaves(a), T.leaves(b)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
