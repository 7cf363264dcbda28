"""Checkpoints of tensor-parallel, fsdp_auto and expert-parallel sessions
hold the reference's global layout.

The port's sessions (``_torch_ckpt_cases.RUNS``: qwen3-1.7b zero1 on a
``(2, 2)`` mesh exact and on the int8 wire with EF, qwen1.5-110b
fsdp_auto ``tp_fsdp`` on ``(2, 2)``, phi-3.5-MoE zero1 with the
expert-parallel dispatch on ``(2, 2)``; scaled down) and the reference's
own step builders on a ``jax.sharding.Mesh`` of 4 fake CPU devices
(worker ``_torch_ckpt_ref.py``, one spawn) start from the launcher's
seed-0 parameters.  Held:

* after 2 steps, the port's ``arrays.npz`` has the keys, shapes and
  dtypes of the reference's global state (``opt_flat``: ``np.asarray``
  of every optimizer leaf; the parameters whole), its moments and
  parameters within ``test_torch_tp.py``'s tolerances (``rtol=1e-5``,
  ``atol=5e-9``, QKV bias's ``bk`` ``1e-7``; the int8 wire's
  ``atol=6e-6``); the EF residuals are
  each rank's rounding error, which moves by a grid step where a last-bit
  difference of the gradient moves a code: all within two of the
  leaf's largest residual (a step), below 1e-6 for 99 % of the elements
  (measured: at most 0.4 % of a leaf's elements, 6.3e-5 apart);
* from a state both packages hold bitwise, the arrays are byte-equal:
  the initial state, and the state the reference's own
  ``restore_session`` reads from the port's checkpoint (its
  ``opt_flat`` byte-equal to the file's arrays);
* an expert-parallel session's model columns keep replicas that differ
  (ROADMAP queue 3): the reference's ``np.asarray`` reads model column
  0's devices, and the port stores column 0's state;
* ``--moe-dispatch ep --mesh 2x2 --ckpt-dir`` trains past a save and a
  rerun resumes from it.
"""
import json

import numpy as np
import pytest

import _torch_ckpt_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.ft import SimulatedFailure
from repro_torch.launch import bootstrap, train

RUNS = sorted(C.RUNS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run on the port: its initial arrays, then K steps and a
    checkpoint; then the reference's runs and its restore of each port
    checkpoint (one worker)."""
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    port, tasks, inits = {}, [], {}
    for run in RUNS:
        model, mode, shape, _, sync = C.RUNS[run]
        if model not in inits:
            inits[model] = C.init_numpy(model)
        sess = C.start(C.session(model, mode, shape, sync), inits[model])
        first = C.arrays(sess)
        for s in range(C.K):
            bootstrap.run_step(sess, s)
        d = str(tmp / run)
        C.save(sess, d, C.K)
        port[run] = dict(first=first, sess=sess, ckpt=d,
                         file=C.read(d, C.K))
        tasks += [C.task(run, "train", run, steps=C.K),
                  C.task(run, "restore", run + "_restore", ckpt=d,
                         step=C.K)]
    ref = C.reference(tmp, tasks, sorted(inits))
    return port, ref


def _opt(z: dict) -> dict:
    return {k[len("opt_"):]: v for k, v in z.items() if k.startswith("opt_")}


@pytest.mark.parametrize("run", RUNS)
def test_checkpoint_holds_the_reference_global_state(runs, run,
                                                     one_torch_thread):  # noqa: F811
    port, ref = runs
    got = _opt(port[run]["file"])
    want = C.leaves_of(ref, f"{run}/opt/")
    assert sorted(got) == sorted(want)
    n = len(T.leaves(port[run]["sess"].params[0]))
    atol = 6e-6 if run == "int8" else 5e-9
    for k, b in want.items():
        a = got[k]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        if int(k.split("_")[1]) > 2 * n:  # EF residuals
            d = np.abs(a - b)
            assert (d <= 2 * np.abs(b).max() + 1e-12).all(), k
            assert (d > 1e-6).mean() < 0.01, k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol,
                                       err_msg=k)
    want_p = C.ref_tree(ref, f"{run}/params/")
    C.assert_params_close(
        T.unflatten((path, port[run]["file"][f"p_{i}"])
                    for i, (path, _) in enumerate(T.flatten(want_p))),
        want_p, atol)
    np.testing.assert_allclose(
        port[run]["sess"].opt[0].step, ref[f"{run}/opt/leaf_{2 * n}"])


@pytest.mark.parametrize("run", RUNS)
def test_initial_state_is_byte_equal(runs, run):
    """The state both packages start from bitwise: the port's arrays of it
    are the reference's ``opt_flat`` byte for byte (and the parameters
    the initial ones)."""
    port, ref = runs
    C.assert_same_bytes(_opt(port[run]["first"]),
                        C.leaves_of(ref, f"{run}/opt0/"))


@pytest.mark.parametrize("run", RUNS)
def test_reference_restores_the_port_checkpoint_bitwise(runs, run):
    """The reference's ``restore_session`` reads the port's checkpoint on
    the mesh that wrote it and holds that state bitwise: its
    ``opt_flat`` is the file's arrays, byte for byte."""
    port, ref = runs
    C.assert_same_bytes(C.leaves_of(ref, f"{run}_restore/restored/"),
                        _opt(port[run]["file"]))


def test_expert_parallel_checkpoint_stores_model_column_0(runs):
    """The ep columns' replicas differ after a step; ``np.asarray`` of the
    reference's state reads model column 0's devices, and the port's
    checkpoint is column 0's state: every rank of column 0 gives the
    file's arrays, column 1's would not."""
    port, ref = runs
    differ = 0
    for k, arr in C.leaves_of(ref, "ep/opt/").items():
        col0 = ref.get(f"ep/col0/{k}")
        if col0 is None:  # the step
            continue
        np.testing.assert_array_equal(arr, col0, err_msg=k)
        differ += not np.array_equal(col0, ref[f"ep/col1/{k}"])
    assert differ > 0
    sess = port["ep"]["sess"]
    m0 = T.leaves(sess.opt[0].m)
    m1 = T.leaves(sess.opt[1].m)  # rank (0, 1): data 0, model column 1
    assert sess.ep_comm.ranks[1] == 1
    assert any(not np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(m0, m1))
    z = port["ep"]["file"]
    for i, a in enumerate(T.leaves(sess.params[0])):
        np.testing.assert_array_equal(z[f"p_{i}"], a.numpy())


def test_cli_expert_parallel_checkpoint_saves_and_resumes(tmp_path,
                                                          one_torch_thread):  # noqa: F811
    """``--moe-dispatch ep --mesh 2x2 --ckpt-dir`` trains past its first
    save and a rerun resumes from it.  The resumed
    steps run every model column from column 0's replicas, so they are
    not bitwise the uninterrupted run (whose columns keep their own):
    within 1e-4 of its losses, as the reference's restore would."""
    argv = ["--arch", C.MOE, "--scale-down", "--device", "cpu", "--mesh",
            "2x2", "--moe-dispatch", "ep", "--steps", "4", "--seq-len", "16",
            "--global-batch", "2"]
    straight = train.main(argv)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SimulatedFailure):
        train.main(argv + ck + ["--fail-at-step", "3"])
    assert CheckpointManager(str(tmp_path)).completed_steps() == [2]
    with open(tmp_path / "step_2" / "manifest.json") as f:
        man = json.load(f)
    assert man["world"] == 2 and man["mesh"] == "2x2"
    tail = train.main(argv + ck)
    assert tail.first_step == 2 and len(tail.losses) == 2
    assert max(abs(a - b) for a, b in
               zip(tail.losses, straight.losses[2:])) < 1e-4
