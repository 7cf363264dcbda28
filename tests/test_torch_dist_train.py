"""One rank per process: the train launcher over gloo, against the
in-process world and the reference.

One spawn of 4 plain torch processes (``_torch_dist_train_worker.py``,
each in the environment torchrun gives a rank) runs three process
worlds in turn through ``launch.train.main(argv)``, while one
fake-device JAX worker (``_torch_dist_ref.py``) runs the reference's
recipes from the port's seed-0 weights.  The yardstick is the
in-process run of the same argv (virtual ranks of a ``LocalComm`` or a
``LocalMesh``, on one torch thread as the workers are):

* ZeRO-1 of scaled-down qwen3-1.7b at p = 3, 3 steps: exact, int8 +
  EF, bucketed (``--bucket-bytes 100000``) and ``--grad-sync ring``:
  losses and grad norms, and every rank's params and AdamW moments after
  the last step, bitwise the in-process run's (the scalars and tiny leaves
  fold in rank order, ``comm.fold_sum``).  ``--grad-sync xla`` sums with
  gloo's own all-reduce: within the reference tolerances below.  The
  exact run against the reference's ``zero1_step`` (the recipe of
  ``_torch_zero1_ref.py``): losses within 1e-5, params ``rtol=1e-5,
  atol=1e-9`` (``test_torch_zero1.py``'s).
* ep phi-3.5-MoE on a 2x2 ``DistMesh``, 3 steps: losses, grad norms and
  every rank's params bitwise the in-process 2x2 ``LocalMesh`` run; and
  within ``test_torch_ep_zero1.py``'s tolerances of the reference's
  ``build_zero1`` (losses and grad norm 1e-5; params ``rtol=1e-5,
  atol=1e-9``).
* qwen3-1.7b tensor parallel on a 2x2 ``DistMesh`` (``--mesh 2x2``:
  ZeRO-1 over data, TP over model), 3 steps: every rank's losses, grad
  norms, params and moments against the in-process 2x2 ``LocalMesh``
  run.  The model axis sums with gloo's own all-reduce and
  reduce-scatter; with two ranks a sum has one order, so bitwise.  The
  same for grok-1-314b (MoE) in ``--mode fsdp_auto`` on 2x2, whose
  global dispatch pools the data ranks' tokens over gloo, and for
  hymba-1.5b (the hybrid) in zero1 on 2x2, whose Mamba heads exchange
  their ``[x | z]`` columns with gloo's all-to-all.
* ``moe_ffn_ep`` over a ``DistComm`` of 4 processes, each the backward
  of its own loss: outputs, aux losses and every rank's grads bitwise
  ``value_and_grad_ranks`` on a ``LocalComm(4)`` (one backward of the
  summed losses): the cross-process reverse exchanges and rank-order
  folds carry the other ranks' terms; ``all_reduce_sum``'s backward
  sums every rank's cotangent (gloo's sum: within 1e-6 of the
  in-process one).
* Checkpoints at p = 3, every step: ``--fail-at-step 2`` then a rerun
  resumes on the uninterrupted in-process run's losses and states,
  bitwise; the 3-process checkpoint resumed by 2 processes gives the
  in-process p' = 2 resume's losses and states, bitwise; its
  ``arrays.npz`` is byte-equal to the in-process run's.
* A tensor-parallel checkpoint (qwen3-1.7b on a 2x2 ``DistMesh``, int8
  wire with EF) resumed by the 4 processes on 4x1: its ``arrays.npz``
  byte-equal to the in-process run's, the resumed steps bitwise the
  in-process resume's.
"""
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_train_worker as W
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch import tree as T
from repro_torch.comm import LocalComm
from repro_torch.convert import params_to_numpy
from repro_torch.ft import SimulatedFailure
from repro_torch.launch import bootstrap, train

HERE = os.path.dirname(os.path.abspath(__file__))
BITWISE = ("exact", "int8", "bucket", "ring")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [str(s.getsockname()[1]) for s in socks]
    for s in socks:
        s.close()
    return ports


def _init_numpy(arch, **kw):
    """The launcher's seed-0 initial parameters of ``arch`` scaled down,
    as the reference's numpy tree."""
    sess = bootstrap.build_session(arch=arch, scale_down=True, device="cpu",
                                   steps=1, seq_len=16, global_batch=2,
                                   init_state=False, **kw)
    gen = torch.Generator().manual_seed(0)
    return params_to_numpy(sess.model.init(gen, torch.device("cpu")))


def _record(out, name):
    """In-process ``on_step`` hook: per step the loss and grad norm and
    every local rank's state (the worker's keys, one list per rank)."""
    def hook(step, sess, metrics):
        out.setdefault(f"{name}/loss", []).append(float(metrics["loss"]))
        out.setdefault(f"{name}/gnorm", []).append(
            float(metrics["grad_norm"]))
        for tag, trees in (("param", sess.params),
                           ("m", [o.m for o in sess.opt]),
                           ("v", [o.v for o in sess.opt])):
            for path, _ in T.flatten(trees[0]):
                key = f"{name}/{tag}/" + "/".join(map(str, path))
                out[key] = [T.get(t, path).detach().float().numpy().copy()
                            for t in trees]
    return hook


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the JAX worker sets its own device count
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    inits = {}
    for tag, arch, kw in (("qwen", "qwen3-1.7b", {}),
                          ("phi", "phi3.5-moe-42b-a6.6b",
                           dict(moe_dispatch="ep", dp=2, mp=2))):
        for path, leaf in T.flatten(_init_numpy(arch, **kw)):
            inits[f"{tag}/" + "/".join(map(str, path))] = leaf
    np.savez(tmp / "in.npz", **inits)
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_ref.py"),
         str(tmp / "in.npz"), str(tmp / "ref.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ports = ",".join(_free_ports(3))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_train_worker.py"),
         str(r), ports, str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    # the in-process runs of the same argv, meanwhile
    local = {}
    for name in (*W.ZERO1_RUNS, "ep", "tp", "tp_moe", "tp_hybrid"):
        train.main(W.ARGV[name], on_step=_record(local, name))
    local["moe"] = W.moe_loss_and_grads(LocalComm(4), range(4))
    local["ar"] = W.all_reduce_grad(LocalComm(4), range(4))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(4)]
    # the checkpoint drill in process: uninterrupted, then the p' resume
    # from the 3-process checkpoint
    train.main(W.ckpt_argv("3x1", str(tmp / "local3")),
               on_step=_record(local, "ckpt"))
    shutil.copytree(tmp / "ck2" / "step_2", tmp / "local2" / "step_2")
    train.main(W.ckpt_argv("2x1", str(tmp / "local2")),
               on_step=_record(local, "resume2"))
    # the tensor-parallel checkpoint in process: 2x2 to step 2, then 4x1
    local4 = str(tmp / "local4")
    with pytest.raises(SimulatedFailure):
        train.main(W.tp_ckpt_argv("2x2", local4) + ["--fail-at-step", "2"])
    train.main(W.tp_ckpt_argv("4x1", local4),
               on_step=_record(local, "tp_restore"))
    log = ref.communicate(timeout=300)[0]
    assert ref.returncode == 0, log
    return local, outs, dict(np.load(tmp / "ref.npz")), tmp


def _state_equal(local_name, local, out, name, rank):
    """Rank ``rank``'s params and moments of ``name`` in ``out`` are
    bitwise local rank ``rank``'s of ``local_name``."""
    keys = [k for k in out if k.startswith(name + "/") and
            k.split("/")[1] in ("param", "m", "v")]
    assert keys
    for key in keys:
        want = local[local_name + key[len(name):]][rank]
        np.testing.assert_array_equal(out[key], want, err_msg=key)


@pytest.mark.parametrize("name", BITWISE)
def test_zero1_over_processes_is_bitwise_in_process(world, name):
    local, outs, _, _ = world
    for r in range(3):
        assert outs[r][f"{name}/loss"].tolist() == local[f"{name}/loss"]
        assert outs[r][f"{name}/gnorm"].tolist() == local[f"{name}/gnorm"]
        _state_equal(name, local, outs[r], name, r)


def test_zero1_xla_over_processes_within_tolerance(world):
    """gloo's own sums (the native reduce-scatter, allgather and
    all-reduce) against the in-process rank-order folds."""
    local, outs, _, _ = world
    for r in range(3):
        np.testing.assert_allclose(outs[r]["xla/loss"], local["xla/loss"],
                                   rtol=0, atol=1e-5)
        for key in (k for k in outs[r] if k.startswith("xla/param/")):
            np.testing.assert_allclose(outs[r][key], local[key][r],
                                       rtol=1e-5, atol=1e-9, err_msg=key)


def test_zero1_exact_over_processes_matches_reference(world):
    _, outs, ref, _ = world
    np.testing.assert_allclose(outs[0]["exact/loss"], ref["qwen/losses"],
                               rtol=0, atol=1e-5)
    keys = [k for k in ref if k.startswith("qwen/final/")]
    assert keys
    for key in keys:
        mine = "exact/param/" + key[len("qwen/final/"):]
        for r in range(3):
            np.testing.assert_allclose(outs[r][mine], ref[key], rtol=1e-5,
                                       atol=1e-9, err_msg=key)


def test_ep_over_processes_is_bitwise_in_process(world):
    local, outs, _, _ = world
    assert outs[0]["ep/loss"].tolist() == local["ep/loss"]
    assert outs[0]["ep/gnorm"].tolist() == local["ep/gnorm"]
    for g in range(4):
        keys = [k for k in outs[g] if k.startswith("ep/param/")]
        for key in keys:
            np.testing.assert_array_equal(outs[g][key], local[key][g],
                                          err_msg=f"rank {g} {key}")


def test_tp_over_processes_is_bitwise_in_process(world):
    local, outs, _, _ = world
    for g in range(4):
        assert outs[g]["tp/loss"].tolist() == local["tp/loss"]
        assert outs[g]["tp/gnorm"].tolist() == local["tp/gnorm"]
        _state_equal("tp", local, outs[g], "tp", g)


def test_tp_moe_over_processes_is_bitwise_in_process(world):
    """grok-1-314b fsdp_auto on a 2x2 ``DistMesh``: the global dispatch's
    pool gathered over the data axis with gloo's allgather, its rows
    back by gloo's reduce-scatter; two ranks' sums have one order."""
    local, outs, _, _ = world
    for g in range(4):
        assert outs[g]["tp_moe/loss"].tolist() == local["tp_moe/loss"]
        assert outs[g]["tp_moe/gnorm"].tolist() == local["tp_moe/gnorm"]
        _state_equal("tp_moe", local, outs[g], "tp_moe", g)


def test_tp_hybrid_over_processes_is_bitwise_in_process(world):
    """hymba-1.5b zero1 on a 2x2 ``DistMesh``: the Mamba heads' all-to-all
    of ``[x | z]`` over gloo (exact moves), the partial sums' all-reduce
    of two ranks (one order)."""
    local, outs, _, _ = world
    for g in range(4):
        assert outs[g]["tp_hybrid/loss"].tolist() == local["tp_hybrid/loss"]
        assert outs[g]["tp_hybrid/gnorm"].tolist() == \
            local["tp_hybrid/gnorm"]
        _state_equal("tp_hybrid", local, outs[g], "tp_hybrid", g)


def test_ep_over_processes_matches_reference(world):
    _, outs, ref, _ = world
    np.testing.assert_allclose(outs[0]["ep/loss"], ref["phi/loss"][:, 0],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[0]["ep/gnorm"],
                               ref["phi/grad_norm"][:, 0], rtol=0, atol=1e-5)
    for g in range(4):
        keys = [k for k in ref if k.startswith(f"phi/final/{g}/")]
        assert keys
        for key in keys:
            mine = "ep/param/" + key[len(f"phi/final/{g}/"):]
            np.testing.assert_allclose(outs[g][mine], ref[key], rtol=1e-5,
                                       atol=1e-9, err_msg=f"rank {g} {key}")


def test_moe_ffn_ep_backward_across_processes(world):
    local, outs, _, _ = world
    for r, (o, a, g) in enumerate(local["moe"]):
        np.testing.assert_array_equal(outs[r]["moe/out"], o.numpy())
        np.testing.assert_array_equal(outs[r]["moe/aux"], a.numpy())
        np.testing.assert_array_equal(outs[r]["moe/g_x"], g["x"].numpy())
        for k, v in g["p"].items():
            assert v.abs().sum() > 0, k
            np.testing.assert_array_equal(outs[r][f"moe/g_{k}"], v.numpy(),
                                          err_msg=f"rank {r} {k}")


def test_all_reduce_sum_backward_across_processes(world):
    """``DistComm.all_reduce_sum`` under autograd: each process's
    gradient is the sum of every rank's cotangent, as the one backward
    over a ``LocalComm(4)`` gives (within float32 rounding: gloo's sum
    and the rank-order fold may differ in their last bit)."""
    local, outs, _, _ = world
    for r in range(4):
        np.testing.assert_allclose(outs[r]["ar/grad"], local["ar"][r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(outs[r]["ar/grad"], outs[0]["ar/grad"],
                                   rtol=0, atol=0)


def test_checkpoint_resume_same_world_is_bitwise(world):
    """``--fail-at-step 2``, then the rerun resumes from the step-2
    checkpoint: steps 0-1 and 2-3 are the uninterrupted run's."""
    local, outs, _, _ = world
    for r in range(3):
        got = outs[r]["fail/loss"].tolist() + outs[r]["resume/loss"].tolist()
        assert got == local["ckpt/loss"]
        _state_equal("ckpt", local, outs[r], "resume", r)


def test_checkpoint_of_three_processes_resumed_by_two(world):
    local, outs, _, _ = world
    for r in range(2):
        assert outs[r]["resume2/loss"].tolist() == local["resume2/loss"]
        assert len(local["resume2/loss"]) == 2  # steps 2 and 3
        _state_equal("resume2", local, outs[r], "resume2", r)


def test_tp_checkpoint_of_processes_restored_on_4x1(world):
    """A 2x2 tensor-parallel checkpoint (int8 wire with EF) written by 4
    processes (every leaf gathered over the data axis, then over the
    model axis) and restored by 4 processes on a 4x1 mesh: its bytes
    are the in-process run's, and the resumed steps (losses, grad norms,
    every rank's state) are the in-process resume's, bitwise."""
    local, outs, _, tmp = world
    mine = (tmp / "ck4" / "step_2" / "arrays.npz").read_bytes()
    assert mine == (tmp / "local4" / "step_2" / "arrays.npz").read_bytes()
    for r in range(4):
        assert outs[r]["tp_restore/loss"].tolist() == \
            local["tp_restore/loss"]
        assert len(local["tp_restore/loss"]) == 2  # steps 2 and 3
        assert outs[r]["tp_restore/gnorm"].tolist() == \
            local["tp_restore/gnorm"]
        _state_equal("tp_restore", local, outs[r], "tp_restore", r)


def test_checkpoint_of_processes_is_byte_equal_in_process(world):
    _, _, _, tmp = world
    mine = (tmp / "ck2" / "step_2" / "arrays.npz").read_bytes()
    assert mine == (tmp / "local3" / "step_2" / "arrays.npz").read_bytes()
