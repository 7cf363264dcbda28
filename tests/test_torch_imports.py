"""The port stands alone: no JAX, nothing of ``repro``; and its launcher runs.

* every ``repro_torch`` module imports in a subprocess where
  ``sys.modules["jax"]`` and ``sys.modules["repro"]`` are ``None`` (any
  import of either fails there);
* an AST scan finds no ``jax`` or ``repro`` import in
  ``src/repro_torch/`` or ``chip_smoke.py``;
* the train CLI runs the zero1 main path on the CPU at a tiny size,
  exact, on the int8 wire, bucketed and with each baseline grad sync,
  and the expert-parallel MoE path on a 2x2 mesh; the elastic drill's
  CLI shrinks a world on the CPU;
* the serve CLI (``python -m repro_torch.launch.serve``) generates on
  the CPU when asked, and refuses to start without a card otherwise;
* ``launch/mesh.py`` makes no process group on import, and in torchrun's
  environment (a world of one process, gloo) both launchers join the
  process world and run where JAX and ``repro`` cannot be imported.
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


def test_every_family_builds_and_runs_without_jax_or_repro():
    """Every arch of the port's ``ALIASES`` (all six families: the
    hybrid, xLSTM, encoder-decoder and VLM modules among them) builds,
    initializes and runs a forward on the CPU in a process where JAX and
    ``repro`` cannot be imported."""
    code = (
        "import sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
        "import torch\n"
        "from repro_torch.configs import ALIASES, get_config\n"
        "from repro_torch.models import build\n"
        "fams = set()\n"
        "for arch in ALIASES:\n"
        "    cfg = get_config(arch).scaled_down()\n"
        "    m = build(cfg, remat=False)\n"
        "    p = m.init(torch.Generator().manual_seed(0))\n"
        "    ex = {}\n"
        "    if cfg.family == 'encdec':\n"
        "        ex['frames'] = torch.zeros(1, 4, cfg.d_model)\n"
        "    if cfg.family == 'vlm':\n"
        "        ex['image_embeds'] = torch.zeros(1, cfg.n_image_tokens,"
        " cfg.d_model)\n"
        "    out = m.forward_logits(p, torch.zeros(1, 4, dtype=torch.long),"
        " **ex)\n"
        "    out = out[0] if isinstance(out, tuple) else out\n"
        "    assert out.shape == (1, 4, cfg.vocab_size), arch\n"
        "    fams.add(cfg.family)\n"
        "print('FAMILIES', sorted(fams))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ("FAMILIES ['dense', 'encdec', 'hybrid', 'moe', 'ssm_xlstm', "
            "'vlm']") in proc.stdout


def test_process_world_runs_without_jax_or_repro():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    code = (
        "import sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
        "import torch.distributed as dist\n"
        "from repro_torch.launch import mesh, serve, train\n"
        "assert not dist.is_initialized() and mesh.is_process_world()\n"
        "run = train.main(['--arch', 'qwen3-1.7b', '--scale-down', "
        "'--device', 'cpu', '--mesh', '1x1', '--mode', 'zero1', '--steps', "
        "'1', '--seq-len', '8', '--global-batch', '1'])\n"
        "assert dist.get_backend() == 'gloo' and len(run.losses) == 1\n"
        "out = serve.main(['--arch', 'phi3.5-moe-42b-a6.6b', '--scale-down', "
        "'--device', 'cpu', '--moe-dispatch', 'ep', '--ep-devices', '1', "
        "'--batch', '1', '--prompt-len', '8', '--max-new', '2'])\n"
        "assert out.tokens.shape == (1, 2)\n"
        "print('PROCESS WORLD OK')\n")
    env = _env()
    env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PROCESS WORLD OK" in proc.stdout
    assert "process world: 1 processes over gloo" in proc.stdout


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


@pytest.mark.parametrize("extra", [["--mesh", "2x2", "--mode", "fsdp_auto",
                                    "--moe-dispatch", "ep"]])
def test_train_cli_refuses_unported_moe_flags(extra, tmp_path):
    """The MoE flags the port refuses: ep under fsdp_auto (ep runs in
    mode zero1 only, as the reference's).  Tensor parallelism trains:
    ``test_torch_tp_moe.py``."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--scale-down",
                    "--device", "cpu", "--steps", "1", "--seq-len", "8",
                    "--global-batch", "2", *extra])
    assert not any(tmp_path.iterdir())


def _checkpoint(directory, step):
    """The manifest and the optimizer arrays' shapes of a checkpoint."""
    import json
    import numpy as np
    path = os.path.join(str(directory), f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    z = np.load(os.path.join(path, "arrays.npz"))
    return man, {k: z[k].shape for k in z.files}


@pytest.mark.parametrize("extra", [["--moe-dispatch", "rowwise"],
                                   ["--moe-dispatch", "global"]])
def test_train_cli_checkpoints_moe_on_a_model_axis(extra, tmp_path):
    """A checkpoint directory with a model axis under either single-pool
    dispatch is accepted: one step writes the whole leaves and the
    moments of the data world (the layout and the resharding are held
    against the reference in ``test_torch_tp_ckpt.py`` and
    ``test_torch_tp_reshard.py``)."""
    from repro_torch.launch import train
    train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--scale-down", "--device",
                "cpu", "--mesh", "2x2", "--steps", "1", "--seq-len", "8",
                "--global-batch", "2", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "1", *extra])
    man, shapes = _checkpoint(tmp_path, 1)
    n = man["n_param_leaves"]
    assert (man["world"], man["mesh"]) == (2, "2x2")
    assert sum(k.startswith("opt_") for k in shapes) == 2 * n + 1
    assert shapes["opt_leaf_0"][1:] == shapes["p_0"][1:]


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
                                   ["--grad-sync", "ring", "--bucket-bytes",
                                    "1000"], ["--bucket-bytes", "0"]])
def test_train_cli_refuses_unported_flags(extra, tmp_path):
    """The checkpoint flags' bounds (a positive interval, a step >= 0)
    and the sync's own refusals (bucketing is circulant only and takes a
    positive size) exit with a message."""
    from repro_torch.launch import train
    extra = [str(tmp_path) if x == "{tmp}" else x for x in extra]
    with pytest.raises(SystemExit):
        train.main(["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
                    "--mesh", "3x1", "--steps", "1", "--seq-len", "8",
                    "--global-batch", "3", *extra])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("extra", [["--arch", "hymba-1.5b", "--mesh", "1x3"],
                                   ["--arch", "xlstm-125m", "--mode",
                                    "fsdp_auto"]])
def test_train_cli_checkpoints_tensor_parallel_and_fsdp_auto(extra,
                                                             tmp_path):
    """A checkpoint directory with tensor parallelism or fsdp_auto is
    accepted: one step writes every leaf whole, and its moments (zero1
    on a data world of 1; fsdp_auto's whole ``m`` and ``v``) of the
    parameters' shapes (the layout and the resharding are held against
    the reference in ``test_torch_tp_ckpt.py`` and
    ``test_torch_tp_reshard.py``)."""
    from repro_torch.launch import train
    train.main(["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
                "--mesh", "3x1", "--steps", "1", "--seq-len", "8",
                "--global-batch", "3", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "1", *extra])
    man, shapes = _checkpoint(tmp_path, 1)
    n = man["n_param_leaves"]
    assert man["mesh"] == ("1x3" if "--mesh" in extra else "3x1")
    assert [shapes[f"opt_leaf_{i}"] for i in range(n)] == \
        [shapes[f"p_{i}"] for i in range(n)]


@pytest.mark.parametrize("arch, extra", [
    pytest.param("qwen3-1.7b", ["--mesh", "1x3"], id="extra0"),
    pytest.param("qwen3-1.7b", ["--mode", "fsdp_auto"], id="extra1"),
    pytest.param("hymba-1.5b", ["--mesh", "1x3"], id="hymba-mesh-1x3")])
def test_train_cli_runs_tensor_parallel_and_fsdp_auto(arch, extra):
    """``--mesh 1x3`` (tensor parallel over three virtual model ranks;
    the scaled-down hymba's heads, channels and vocab divide no 3, so
    every leaf replicates) and ``--mode fsdp_auto`` (on the 3x1 mesh)
    train, on the losses of the 3x1 zero1 run of the same flags."""
    from repro_torch.launch import train
    argv = ["--arch", arch, "--scale-down", "--device", "cpu",
            "--mesh", "3x1", "--steps", "2", "--seq-len", "8",
            "--global-batch", "3"]
    want = train.main(argv).losses
    got = train.main(argv + extra).losses
    assert max(abs(a - b) for a, b in zip(got, want)) < 1e-5


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
    """A model axis of no rank, and the card where there is none, exit
    with a message (the drill on a model axis of 2:
    ``test_torch_tp_reshard.py``)."""
    from repro_torch.launch import elastic
    with pytest.raises(SystemExit, match="mp must be positive"):
        elastic.main(["--scale-down", "--device", "cpu", "--mp", "0",
                      "--shrink-at-step", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            elastic.main(["--scale-down", "--shrink-at-step", "2"])


def test_serve_cli_on_cpu_and_refused_without_card():
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen3-1.7b", "--scale-down", "--batch", "2", "--prompt-len",
            "8", "--max-new", "4"]
    proc = subprocess.run(base + ["--device", "cpu"], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4)" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(base, capture_output=True, text=True,
                              env=_env(), timeout=300)
        assert proc.returncode != 0 and "--device cpu" in proc.stderr
