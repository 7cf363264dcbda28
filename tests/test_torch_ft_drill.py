"""The port's elastic drill on the CPU against the reference's step.

The scaled-down drill (qwen3-1.7b, 8 steps, checkpoints every 3): shrink
4 -> 3 and grow 3 -> 4 exact, and shrink 4 -> 3 on the int8 wire with
EF.  The post-resume losses are bitwise the p' reference run's (f32),
within 0.05 of it and of the exact drill's (int8 + EF, the reference's
gate).  The params after the first resumed step, restored from the
drill's checkpoint, are held against the reference's ``zero1_step``
driven directly at p' from the same checkpoint read and resized by the
reference (worker ``_torch_elastic_ref.py``, 4 fake CPU devices): loss
1e-5, params ``rtol=1e-5`` with ``atol=1e-9`` exact and, on the int8
wire, a tenth of the step's learning rate (``test_torch_zero1.py``'s
rule, which gives its 6e-6 at lr 6e-5; here lr is 1e-3, and one element
of 16,384 lands 1.75e-5 apart).  The drill on a model axis:
``test_torch_tp_reshard.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import bootstrap
from repro_torch.launch.elastic import run_drill
from repro_torch.optim import adamw

HERE = os.path.dirname(os.path.abspath(__file__))


COMMON = dict(arch="qwen3-1.7b", scale_down=True, steps=8, seq_len=16,
              global_batch=12, ckpt_every=3, device="cpu")
#: tag -> (run_drill kwargs, world, new world)
DRILLS = {"shrink": (dict(world=4, shrink_at_step=5, fail_rank=2), 4, 3),
          "grow": (dict(world=3, grow_at_step=4, grow_to=4), 3, 4),
          "shrink_int8": (dict(world=4, shrink_at_step=5, fail_rank=2,
                               wire_dtype="int8", io_faults=1), 4, 3)}


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Every drill, its checkpoints kept; then the reference's first step
    after each resize from the same checkpoint (one worker)."""
    root = tmp_path_factory.mktemp("drills")
    res, runs = {}, []
    for tag, (kw, world, new) in DRILLS.items():
        d = str(root / tag)
        res[tag] = r = run_drill(ckpt_dir=d, **COMMON, **kw)
        runs.append({"tag": tag, "ckpt_dir": d, "step": r["resumed_step"],
                     "world": world, "new_world": new,
                     "wire_dtype": kw.get("wire_dtype"),
                     "steps": COMMON["steps"], "lr": 1e-3, "warmup": 2,
                     "global_batch": COMMON["global_batch"],
                     "seq_len": COMMON["seq_len"]})
    with open(root / "in.json", "w") as f:
        json.dump(runs, f)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_elastic_ref.py"),
         str(root / "in.json"), str(root / "out.npz")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return res, runs, dict(np.load(root / "out.npz"))


@pytest.mark.parametrize("tag", sorted(DRILLS))
def test_drill_resumes_on_the_reference_trajectory(drills, tag):
    res = drills[0][tag]
    rep = res["report"]
    assert not rep.restarted and rep.replans
    assert all(r.verified and r.new_p == res["new_world"]
               for r in rep.replans)
    assert [n for n, _ in rep.phases] == ["drain", "replan", "reshard",
                                          "resume"]
    assert [s for s, _ in res["post"]] == list(range(res["resumed_step"], 8))
    if tag == "grow":
        assert res["lost_steps"] == 0 and res["resumed_step"] == 4
    else:
        assert res["resumed_step"] == 3 and res["lost_steps"] == 2
        assert rep.evicted >= 1
    if tag == "shrink_int8":
        assert rep.io_failures == 1 and "ckpt_io" in res["fired"]
        assert res["max_abs_diff"] <= 0.05
        exact = drills[0]["shrink"]["post"]
        assert max(abs(a - b) for (_, a), (_, b)
                   in zip(res["post"], exact)) <= 0.05
    else:
        assert res["bitwise"], (res["post"], res["ref"])


@pytest.mark.parametrize("tag", sorted(DRILLS))
def test_first_resumed_step_matches_reference_step(drills, tag):
    _, runs, ref = drills
    run = next(r for r in runs if r["tag"] == tag)
    sess = bootstrap.build_session(
        arch="qwen3-1.7b", scale_down=True, steps=8, seq_len=16,
        global_batch=12, dp=run["new_world"], mode="zero1",
        wire_dtype=run["wire_dtype"], lr=1e-3, warmup=2, device="cpu",
        init_state=False)
    step, man = bootstrap.restore_session(sess, CheckpointManager(
        run["ckpt_dir"]), step=run["step"])
    assert step == run["step"] and man["world"] == run["world"]
    loss = float(bootstrap.run_step(sess, step)["loss"])
    assert abs(loss - float(ref[f"{tag}/loss"])) <= 1e-5
    # the resumed drill's own first loss is this one
    assert drills[0][tag]["post"][0] == (step, loss)
    # int8 wire: a tenth of this step's learning rate, the rule behind
    # test_torch_zero1.py's 6e-6 (there at lr 6e-5): below any update a
    # code that moved a grid step would flip.
    lr = float(adamw.lr_at(sess.opt_cfg, sess.opt[0].step))
    atol = lr / 10 if run["wire_dtype"] else 1e-9
    for path, t in T.flatten(sess.params[0]):
        np.testing.assert_allclose(t.numpy(), ref[tag + "/" + "/".join(path)],
                                   rtol=1e-5, atol=atol,
                                   err_msg=".".join(path))
