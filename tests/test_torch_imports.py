"""The port stands alone: no JAX, nothing of ``repro``; and its launcher runs.

* every ``repro_torch`` module imports in a subprocess where
  ``sys.modules["jax"]`` and ``sys.modules["repro"]`` are ``None`` (any
  import of either fails there);
* an AST scan finds no ``jax`` or ``repro`` import in
  ``src/repro_torch/`` or ``chip_smoke.py``;
* the train CLI runs the zero1 main path on the CPU at a tiny size,
  exact, on the int8 wire, bucketed and with each baseline grad sync,
  and the expert-parallel MoE path on a 2x2 mesh; the elastic drill's
  CLI shrinks a world on the CPU.
"""
import ast
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    return env


def test_every_module_imports_without_jax_or_repro():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "print('IMPORTED', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED" in proc.stdout


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                         "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_train_cli_zero1_on_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
           "--mesh", "3x1", "--mode", "zero1", "--steps", "2",
           "--seq-len", "16", "--global-batch", "3", "--log-every", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(x) for x in re.findall(r"loss (\S+)", proc.stdout)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def test_train_cli_zero1_int8_wire_on_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
           "--mesh", "3x1", "--mode", "zero1", "--steps", "2",
           "--seq-len", "16", "--global-batch", "3", "--log-every", "1",
           "--wire-dtype", "int8", "--no-error-feedback"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(x) for x in re.findall(r"loss (\S+)", proc.stdout)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def test_train_cli_moe_ep_on_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "phi3.5-moe-42b-a6.6b", "--scale-down", "--device",
           "cpu", "--mesh", "2x2", "--mode", "zero1", "--moe-dispatch", "ep",
           "--steps", "2", "--seq-len", "16", "--global-batch", "2",
           "--log-every", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(x) for x in re.findall(r"loss (\S+)", proc.stdout)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("extra", [["--mesh", "2x2"],
                                   ["--mesh", "2x2", "--moe-dispatch",
                                    "rowwise"],
                                   ["--mesh", "2x2", "--moe-dispatch",
                                    "global"]])
def test_train_cli_refuses_unported_moe_flags(extra):
    """A model axis without ep (tensor parallelism) is not ported, with
    either single-pool dispatch (global or per-sequence rowwise)."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--scale-down",
                    "--device", "cpu", "--steps", "1", "--seq-len", "8",
                    "--global-batch", "2", *extra])


@pytest.mark.parametrize("extra", [
    ["--grad-sync", "ring"], ["--grad-sync", "xla"],
    ["--grad-sync", "allreduce"], ["--bucket-bytes", "100000"],
    ["--bucket-bytes", "100000", "--wire-dtype", "int8"]])
def test_train_cli_grad_sync_modes_on_cpu(extra):
    """``--grad-sync ring|xla|allreduce`` and ``--bucket-bytes`` reach
    the sync and train (in process: the launcher's ``main``)."""
    from repro_torch.launch import train
    run = train.main(["--arch", "qwen3-1.7b", "--scale-down", "--device",
                      "cpu", "--mesh", "3x1", "--mode", "zero1", "--steps",
                      "2", "--seq-len", "16", "--global-batch", "3",
                      "--log-every", "1", *extra])
    assert len(run.losses) == 2 and all(math.isfinite(x) for x in run.losses)


def test_train_cli_on_step_sees_each_step():
    """``main(argv, on_step=...)`` hands each finished step's session and
    metrics to the hook, in order, the metrics those the run returns."""
    from repro_torch.launch import train
    seen = []
    run = train.main(["--arch", "qwen3-1.7b", "--scale-down", "--device",
                      "cpu", "--mesh", "3x1", "--mode", "zero1", "--steps",
                      "3", "--seq-len", "16", "--global-batch", "3"],
                     on_step=lambda step, sess, metrics: seen.append(
                         (step, sess.world, float(metrics["loss"]))))
    assert seen == [(s, 3, loss) for s, loss in enumerate(run.losses)]


@pytest.mark.parametrize("extra", [["--ckpt-every", "0"],
                                   ["--fail-at-step", "-1"],
                                   ["--mesh", "2x2"], ["--mode", "fsdp_auto"],
                                   ["--grad-sync", "ring", "--bucket-bytes",
                                    "1000"], ["--bucket-bytes", "0"]])
def test_train_cli_refuses_unported_flags(extra):
    """Unported features, the checkpoint flags' bounds (a positive
    interval, a step >= 0) and the sync's own refusals (bucketing is
    circulant only and takes a positive size) exit with a message."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
                    "--mesh", "3x1", "--steps", "1", "--seq-len", "8",
                    "--global-batch", "3", *extra])


def test_elastic_cli_shrinks_on_cpu(capsys):
    """``python -m repro_torch.launch.elastic`` (in process: its ``main``)
    shrinks 4 -> 3 on the CPU and resumes bitwise on its p' reference."""
    from repro_torch.launch import elastic
    res = elastic.main(["--arch", "qwen3-1.7b", "--scale-down", "--device",
                        "cpu", "--steps", "5", "--world", "4",
                        "--shrink-at-step", "4", "--fail-rank", "1",
                        "--seq-len", "8", "--global-batch", "12",
                        "--ckpt-every", "2"])
    assert res["new_world"] == 3 and res["bitwise"]
    assert "vs uninterrupted p' reference: bitwise" in capsys.readouterr().out


def test_elastic_cli_refuses_model_axis_and_cuda_without_card():
    from repro_torch.launch import elastic
    with pytest.raises(SystemExit):
        elastic.main(["--scale-down", "--device", "cpu", "--mp", "2",
                      "--shrink-at-step", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            elastic.main(["--scale-down", "--shrink-at-step", "2"])
