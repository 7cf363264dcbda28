"""Checkpoints of tensor-parallel, fsdp_auto and expert-parallel sessions
restored on other ``D x M`` meshes and modes, and the elastic drill on a
model axis, against the reference's own restore.

The port's checkpoints (``_torch_ckpt_cases.RUNS``, written after 2 of 4
steps) are restored by ``bootstrap.restore_session`` on every pair the
reference's ``restore_session`` accepts: the exact (2, 2) zero1
checkpoint on (2, 2), (4, 1), (1, 4) and (1, 1) ``single``; the
fsdp_auto (2, 2) one on fsdp_auto (1, 4) and zero1 (2, 2); the int8 +
EF one on (2, 2) and (4, 1); the expert-parallel one on (2, 2).  The
reference (worker ``_torch_ckpt_ref.py``, one spawn) restores the same
files on the same meshes with its own ``restore_session`` and takes one
step.  Held:

* every restored state, written back (``params_whole`` and
  ``opt_flat``), is byte-equal to the file, or where the data world
  changed, to the file's arrays through ``resize_zero1_state`` (the
  reference's resize, bitwise: ``test_torch_ft_state.py``);
* on the mesh that wrote it, the resumed steps are bitwise the
  uninterrupted run's (losses, grad norms, every rank's parameters);
  not for the expert-parallel session, whose model columns keep
  replicas that differ (ROADMAP queue 3) and resume from column 0's
  (``test_torch_tp_ckpt.py``);
* on another mesh (and for ep on its own), the first resumed step
  matches the reference's from the same checkpoint on that mesh: loss
  and grad norm within 1e-5, the parameters within ``rtol=1e-5`` /
  ``atol=5e-9`` (``bk`` ``1e-7``; the int8 wire's ``6e-6``),
  ``test_torch_tp.py``'s;
* pairs the reference cannot restore are refused with a message: EF
  residuals into a sync without them, and a zero1 state padded for a
  data world of 3 restored whole (fsdp_auto);
* the elastic drill on a model axis (``run_drill(mp=2)``): 2x2 -> 1x2
  (rank 1 lost) and 1x2 -> 2x2, each resumed bitwise the port's
  uninterrupted run on the new mesh from the same checkpoint, and its
  first resumed step against the reference's from that checkpoint
  (loss 1e-5, parameters ``rtol=1e-5`` / ``atol=1e-9``, the drill's of
  ``test_torch_ft_drill.py``).
"""
import pytest

import _torch_ckpt_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import params_to_numpy
from repro_torch.launch import bootstrap
from repro_torch.launch.elastic import run_drill

#: case -> (checkpoint's run, session's mode, mesh)
RESTORES = {"zero1_2x2": ("zero1", "zero1", (2, 2)),
            "zero1_4x1": ("zero1", "zero1", (4, 1)),
            "zero1_1x4": ("zero1", "zero1", (1, 4)),
            "zero1_single": ("zero1", "single", (1, 1)),
            "fsdp_1x4": ("fsdp", "fsdp_auto", (1, 4)),
            "fsdp_zero1_2x2": ("fsdp", "zero1", (2, 2)),
            "int8_2x2": ("int8", "zero1", (2, 2)),
            "int8_4x1": ("int8", "zero1", (4, 1)),
            "ep_2x2": ("ep", "zero1", (2, 2))}
#: the drills: tag -> (run_drill kwargs, new mesh)
DRILL = dict(arch="qwen3-1.7b", scale_down=True, steps=6, seq_len=16,
             global_batch=4, ckpt_every=2, mp=2, device="cpu")
DRILLS = {"shrink": (dict(world=2, shrink_at_step=3, fail_rank=1), (1, 2)),
          "grow": (dict(world=1, grow_at_step=2, grow_to=2), (2, 2))}


def _same_mesh(case):
    run, mode, shape = RESTORES[case]
    return (mode, shape) == C.RUNS[run][1:3] and run != "ep"


def _restored(case, ckpt):
    run, mode, shape = RESTORES[case]
    model, _, _, _, sync = C.RUNS[run]
    sess = C.session(model, mode, shape, sync)
    step, _ = bootstrap.restore_session(sess, CheckpointManager(ckpt))
    assert step == C.K
    return sess


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's checkpoints and uninterrupted runs, the drills; then
    the reference's restore and step of each (one worker)."""
    tmp = tmp_path_factory.mktemp("tp_reshard")
    ckpts, straight, tasks, inits = {}, {}, [], {}
    for run in sorted(C.RUNS):
        model, mode, shape, _, sync = C.RUNS[run]
        if model not in inits:
            inits[model] = C.init_numpy(model)
        sess = C.start(C.session(model, mode, shape, sync), inits[model])
        for s in range(C.K):
            bootstrap.run_step(sess, s)
        ckpts[run] = str(tmp / run)
        C.save(sess, ckpts[run], C.K)
        straight[run] = ([bootstrap.run_step(sess, s)
                          for s in range(C.K, C.TOTAL)], sess)
    for case, (run, mode, shape) in RESTORES.items():
        if not _same_mesh(case):
            rkw = ({"mode": "tp_fsdp"} if mode == "fsdp_auto" else {})
            tasks.append(C.task(run, "restore", case, mode=mode,
                                shape=list(shape), recipe=rkw,
                                ckpt=ckpts[run], step=C.K))
    drills = {}
    for tag, (kw, new) in DRILLS.items():
        d = str(tmp / ("drill_" + tag))
        drills[tag] = r = run_drill(ckpt_dir=d, **DRILL, **kw)
        tasks.append(dict(kind="restore", tag="drill_" + tag,
                          model="qwen3-1.7b", mode="zero1", shape=list(new),
                          total_steps=DRILL["steps"],
                          batch=DRILL["global_batch"], lr=1e-3, warmup=2,
                          ckpt=d, step=r["resumed_step"]))
        drills[tag]["ckpt_dir"] = d
    ref = C.reference(tmp, tasks, sorted(inits))
    return ckpts, straight, drills, ref


@pytest.mark.parametrize("case", sorted(RESTORES))
def test_restore_on_another_mesh(runs, case, one_torch_thread):  # noqa: F811
    ckpts, straight, _, ref = runs
    run = RESTORES[case][0]
    sess = _restored(case, ckpts[run])
    C.assert_same_bytes(C.arrays(sess),
                        C.resized(C.read(ckpts[run], C.K), sess,
                                  C.RUNS[run][2][0]))
    if _same_mesh(case):
        metrics, done = straight[run]
        for s, want in zip(range(C.K, C.TOTAL), metrics):
            got = bootstrap.run_step(sess, s)
            assert float(got["loss"]) == float(want["loss"])
            assert float(got["grad_norm"]) == float(want["grad_norm"])
        for a, b in zip(sess.params, done.params):
            assert all(T.same_bits(x, y)
                       for x, y in zip(T.leaves(a), T.leaves(b)))
        return
    got = bootstrap.run_step(sess, C.K)
    assert abs(float(got["loss"]) - float(ref[f"{case}/loss"])) < 1e-5
    assert abs(float(got["grad_norm"]) - float(ref[f"{case}/gnorm"])) < 1e-5
    C.assert_params_close(params_to_numpy(bootstrap.params_whole(sess)),
                          C.ref_tree(ref, f"{case}/params/"),
                          6e-6 if run == "int8" else 5e-9)


def test_ef_checkpoint_into_exact_sync_refused(runs):
    """An int8 + EF checkpoint holds the EF residuals an exact sync has no
    place for: refused, as the reference refuses it (its leaf count)."""
    ckpts = runs[0]
    sess = C.session("qwen3-1.7b", "zero1", (4, 1))
    with pytest.raises(ValueError, match="43 optimizer leaves, session "
                                         "expects 29"):
        bootstrap.restore_session(sess, CheckpointManager(ckpts["int8"]))


def test_padded_zero1_checkpoint_restored_whole_refused(tmp_path):
    """A zero1 state padded for a data world of 3 (``embed``'s 128 rows
    to 129) restored by fsdp_auto, which holds whole leaves: refused
    with the shapes, where the reference's restore would hand the step
    padded moments."""
    sess = C.start(C.session("qwen3-1.7b", "zero1", (3, 1), batch=3),
                   C.init_numpy("qwen3-1.7b"))
    mgr = C.save(sess, str(tmp_path), 0)
    other = C.session("qwen3-1.7b", "fsdp_auto", (2, 2))
    with pytest.raises(ValueError, match=r"embed is \(129, 64\), the "
                       r"session's fsdp_auto state on data world 2 takes "
                       r"\(128, 64\)"):
        bootstrap.restore_session(other, mgr)


@pytest.mark.parametrize("tag", sorted(DRILLS))
def test_drill_on_a_model_axis(runs, tag, one_torch_thread):  # noqa: F811
    """The drill resizes the data axis of a ``D x 2`` mesh: the resumed
    losses are bitwise the port's uninterrupted run on the new mesh
    from the same checkpoint, and its first resumed step is the
    reference's from that checkpoint."""
    res, ref = runs[2][tag], runs[3]
    kw, new = DRILLS[tag]
    assert res["new_world"] == new[0] and res["bitwise"], res
    assert [n for n, _ in res["report"].phases] == ["drain", "replan",
                                                    "reshard", "resume"]
    sess = C.session("qwen3-1.7b", "zero1", new, steps=DRILL["steps"],
                     lr=1e-3, warmup=2)
    step, man = bootstrap.restore_session(
        sess, CheckpointManager(res["ckpt_dir"]), step=res["resumed_step"])
    assert man["world"] == kw["world"]
    loss = float(bootstrap.run_step(sess, step)["loss"])
    assert res["post"][0] == (step, loss)
    assert abs(loss - float(ref[f"drill_{tag}/loss"])) < 1e-5
    C.assert_params_close(params_to_numpy(bootstrap.params_whole(sess)),
                          C.ref_tree(ref, f"drill_{tag}/params/"), 1e-9)
