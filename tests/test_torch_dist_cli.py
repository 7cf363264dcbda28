"""The launchers under torchrun: the process world's CLI and its refusals.

* ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  repro_torch.launch.train ... --device cpu --mesh 2x1`` (the one spawn
  of this file) trains over gloo: rank 0 alone prints the log lines,
  which name the world, and its losses are those of the in-process run
  of the same flags;
* ``launch.mesh.is_process_world()`` is false under plain pytest, so
  the launchers keep their in-process worlds;
* in torchrun's environment (set here, no process group made): a mesh
  or a serving width that differs from the world exits with a message
  before any process group is made (a checkpoint directory with tensor
  parallelism or ``fsdp_auto`` is accepted: it goes on to that check);
  the elastic drill over processes is refused citing ROADMAP.md queue 1
  item 11.2;
  a ``cuda`` world without a card is refused;
* ``--mesh 1x2 --mode fsdp_auto`` under torchrun (a second spawn)
  trains tensor parallel over gloo, on the in-process run's losses.
"""
import math
import os
import pathlib
import re
import socket
import subprocess
import sys

import pytest
import torch

from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch.launch import elastic, mesh, serve, train

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAIN = ["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
         "--mode", "zero1", "--steps", "2", "--seq-len", "16",
         "--global-batch", "2", "--log-every", "1"]


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


@pytest.fixture
def torchrun_env(monkeypatch):
    """Rank 0 of a world of 2, as torchrun would start it (no peer runs:
    each refusal must come before a process group is made)."""
    for key, val in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"),
                     ("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", _free_port())):
        monkeypatch.setenv(key, val)
    yield
    assert not torch.distributed.is_initialized()


def test_train_cli_under_torchrun_over_gloo():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           *TRAIN, "--mesh", "2x1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "process world: 2 processes over gloo, this is rank 0" in out
    assert out.count("step     0") == 1 and out.count("final loss") == 1
    losses = [float(x) for x in re.findall(r"step +\d+  loss (\S+)", out)]
    run = train.main(TRAIN + ["--mesh", "2x1"])
    assert losses == [float(f"{x:.4f}") for x in run.losses]
    assert all(math.isfinite(x) for x in losses)


def test_tensor_parallel_fsdp_auto_under_torchrun_over_gloo():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    argv = [*TRAIN, "--mesh", "1x2", "--mode", "fsdp_auto"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(x) for x in
              re.findall(r"step +\d+  loss (\S+)", proc.stdout)]
    run = train.main(argv)
    assert losses == [float(f"{x:.4f}") for x in run.losses]


def test_in_process_world_under_plain_pytest(capsys):
    assert not mesh.is_process_world()
    run = train.main(TRAIN + ["--mesh", "2x1", "--steps", "1"])
    assert len(run.losses) == 1
    assert "in-process world" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--mesh", "3x1"], ["--mesh", "1x1"],
    ["--arch", "phi3.5-moe-42b-a6.6b", "--moe-dispatch", "ep", "--mesh",
     "2x2"]])
def test_train_mesh_that_differs_from_the_world_is_refused(torchrun_env,
                                                            argv):
    assert mesh.is_process_world()
    with pytest.raises(SystemExit, match="needs a world of"):
        train.main(TRAIN + argv)


@pytest.mark.parametrize("argv", [
    ["--replicas", "3"], ["--replicas", "1"],
    ["--arch", "phi3.5-moe-42b-a6.6b", "--moe-dispatch", "ep",
     "--ep-devices", "3"],
    ["--arch", "phi3.5-moe-42b-a6.6b", "--moe-dispatch", "ep",
     "--ep-devices", "2", "--replicas", "2"]])
def test_serve_width_that_differs_from_the_world_is_refused(torchrun_env,
                                                            argv):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen3-1.7b", "--scale-down", "--device",
                    "cpu", "--batch", "2", "--prompt-len", "8",
                    "--max-new", "2", *argv])


@pytest.mark.parametrize("argv", [
    ["--arch", "hymba-1.5b", "--mesh", "1x2"],
    ["--arch", "xlstm-125m", "--mesh", "2x1", "--mode", "fsdp_auto"]])
def test_tensor_parallelism_and_fsdp_refused_citing_11_2(torchrun_env, argv,
                                                         tmp_path):
    """Tensor parallelism and fsdp_auto train these families under
    torchrun (``test_torch_dist_train.py``'s hymba 2x2 world) and
    checkpoint there (its 2x2 checkpoint resumed on 4x1): a checkpoint
    directory is accepted, and the launcher goes on to the world, whose
    width it checks before any process group is made (here a mesh of 4
    ranks against torchrun's 2); nothing is written.  Only the drill
    over processes still cites item 11.2 (below)."""
    argv = [x.replace("2", "4") if x in ("1x2", "2x1") else x for x in argv]
    with pytest.raises(SystemExit, match="world of 4 processes"):
        train.main(TRAIN + argv + ["--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_elastic_drill_over_processes_refused_citing_11_2(torchrun_env):
    with pytest.raises(SystemExit, match="item 11.2"):
        elastic.main(["--scale-down", "--device", "cpu", "--world", "2",
                      "--shrink-at-step", "2"])


def test_cuda_world_without_a_card_is_refused(torchrun_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.init_world("cuda")
