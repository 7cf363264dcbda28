"""The port's multi-rank serving against the reference's on fake devices.

One subprocess worker (``_torch_serve_ref.py``, 4 fake CPU devices,
meshes through ``repro.compat``) computes the reference's
``ReplicaSet(replicas=3)`` push stats and round-robin tokens, and its
expert-parallel ``ServeEngine`` at pe = 2 (``moe_dispatch="ep"`` on a
``("model",)`` mesh): tokens and per-step logits.  The port runs the
same weights (``convert.params_from_numpy``) on a ``LocalComm``:

* the broadcast fan-out at p in {2, 3, 5}: every replica's weights
  bitwise the source's, ``ceil_log2(p)`` rounds and ``n_leaves *
  ceil_log2(p)`` exchanges; at p = 3 the stats equal the reference's;
* ``ReplicaSet(3)``'s tokens equal the reference's;
* ep decode at pe = 2: logits within 2e-5 of the reference's at every
  step (``test_torch_moe.py``'s MoE tolerance), greedy tokens equal, and
  every rank's logits and caches bitwise rank 0's; the ``permute_rows``
  backend and the plain one give the same tokens;
* the scheduler over the ep engine (one paged cache per rank): tokens
  bitwise one-shot ``generate`` of each request alone, and equal to the
  reference's ``Scheduler`` over its ep engine;
* one rank per process (one spawn of 3 gloo processes,
  ``_torch_dist_serve_worker.py``): ``ReplicaSet(3)`` over a
  ``DistComm`` (fan-out bitwise, ``n_leaves * ceil_log2(3)`` exchanges,
  tokens equal to the reference's and to the in-process set's), the ep
  engine at pe = 2 over 2 processes (logits of every step bitwise the
  in-process engine's, tokens equal to the reference's), the scheduler
  over it (tokens bitwise the in-process scheduler's, equal to the
  reference's), and the serve launcher's argv in both worlds, tokens
  bitwise; the in-process side on one torch thread, as the workers;
* the reference's ``serve-collectives-via-plan`` lint rule on the port's
  ``serve`` package.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_serve_worker as SW
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch import tree as T
from repro_torch.comm import LocalComm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import ceil_log2
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build
from repro_torch.models import transformer as ptr
from repro_torch.serve import ReplicaSet, Scheduler, ServeEngine

HERE = os.path.dirname(os.path.abspath(__file__))
QWEN, PHI = "qwen3-1.7b", "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh") / "out.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the JAX worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_serve_ref.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def _params(ref, prefix, cfg):
    tag = f"{prefix}/param/"
    tree = T.unflatten((tuple(k[len(tag):].split(".")), v)
                       for k, v in ref.items() if k.startswith(tag))
    return params_from_numpy(tree, cfg)


def _cfg(name, **kw):
    return get_config(name).scaled_down(n_layers=2, vocab_size=64, **kw)


@pytest.mark.parametrize("p", [2, 3, 5])
def test_fanout_is_bitwise_in_ceil_log2_rounds(p):
    cfg = _cfg(QWEN)
    model = build(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(p))
    rs = ReplicaSet(model, 24, p)
    st = rs.push_weights(params)
    n = len(T.leaves(params))
    assert st["rounds"] == ceil_log2(p) and st["n_leaves"] == n
    assert st["exchanges"] == rs.comm.exchanges == n * ceil_log2(p)
    src = T.leaves(params)
    for e in rs.engines:
        assert e.params is rs.engines[0].params
        for a, b in zip(src, T.leaves(e.params)):
            assert a.data_ptr() != b.data_ptr()
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_fanout_of_bfloat16_leaves_is_bitwise():
    """bfloat16 leaves (full-width configs' dtype), NaN bits included,
    through a padded row split (n % p != 0)."""
    model = build(_cfg(QWEN), remat=False)
    rs = ReplicaSet(model, 24, 3)
    leaf = torch.randn(7, 5).to(torch.bfloat16)
    leaf[2, 3] = float("nan")
    out = rs._fan_out_leaf(leaf)
    assert out.dtype == torch.bfloat16 and out.shape == leaf.shape
    assert torch.equal(out.view(torch.int16), leaf.view(torch.int16))


def test_replica_set_matches_reference(reference):
    cfg = _cfg(QWEN)
    model = build(cfg, remat=False)
    params = _params(reference, "rep", cfg)
    rs = ReplicaSet(model, 24, 3)
    st = rs.push_weights(params)
    assert (st["n_leaves"], st["bytes"], st["rounds"]) == (
        int(reference["rep/n_leaves"]), int(reference["rep/bytes"]),
        int(reference["rep/rounds"]))
    prompts = reference["rep/prompts"]
    got = rs.generate(prompts, 4)
    np.testing.assert_array_equal(got, reference["rep/tokens"])
    np.testing.assert_array_equal(got, rs.engines[0].generate(prompts, 4))
    with pytest.raises(RuntimeError):
        ReplicaSet(model, 24, 2).generate(prompts, 4)
    with pytest.raises(ValueError):
        ReplicaSet(model, 24, 0)


def _ep_engine(ref, fused=None):
    cfg = _cfg(PHI, moe_dispatch="ep")
    comm = LocalComm(2)
    model = build(cfg, remat=False, ep_comm=comm, use_fused_kernel=fused)
    return ServeEngine(model, _params(ref, "ep", cfg), 16), comm


def test_ep_serving_matches_reference(reference):
    eng, comm = _ep_engine(reference)
    prompts = reference["ep/prompts"]
    want_logits = reference["ep/logits"]
    # the reference's greedy loop, step by step, on the port's ranks
    pm, params = eng.model, eng.params
    toks = torch.as_tensor(prompts)
    caches, logits = ptr.prefill_ep([params] * 2, pm.cfg, [toks] * 2, 16,
                                    comm)
    x0 = comm.exchanges
    for i in range(want_logits.shape[0]):
        np.testing.assert_allclose(logits[0].numpy(), want_logits[i],
                                   rtol=0, atol=2e-5, err_msg=f"step {i}")
        assert torch.equal(logits[1], logits[0])
        for key in ("k", "v"):
            assert torch.equal(caches[1][key], caches[0][key])
        nxt = torch.argmax(logits[0], -1).to(torch.int32)
        caches, logits = ptr.decode_step_ep([params] * 2, pm.cfg, caches,
                                            [nxt] * 2, 8 + i, comm)
    # 3 ceil_log2(2) exchanges per MoE layer per call (test_torch_moe.py)
    assert comm.exchanges - x0 == 3 * pm.cfg.n_layers * want_logits.shape[0]
    got = eng.generate(prompts, want_logits.shape[0])
    np.testing.assert_array_equal(got, reference["ep/tokens"])
    off, _ = _ep_engine(reference, fused=False)
    np.testing.assert_array_equal(off.generate(prompts, got.shape[1]), got)


def test_scheduler_over_ep_engine_matches_reference(reference):
    eng, _ = _ep_engine(reference)
    prompts = reference["ep/sched_prompts"]
    got = SW.scheduled(eng, prompts)
    for i, (toks, n) in enumerate(zip(got, SW.SCHED_NEW)):
        np.testing.assert_array_equal(toks,
                                      reference[f"ep/sched_tokens_{i}"])
        np.testing.assert_array_equal(toks, eng.generate(prompts[i][None],
                                                         n)[0])


@pytest.fixture(scope="module")
def processes(reference, tmp_path_factory):
    """The gloo worlds of ``_torch_dist_serve_worker.py`` (3 ranks, then
    2), one spawn; returns each rank's output."""
    tmp = tmp_path_factory.mktemp("serve_procs")
    np.savez(tmp / "ref.npz", **reference)
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(str(s.getsockname()[1]))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_serve_worker.py"),
         str(r), ",".join(ports), str(tmp / "ref.npz"), str(tmp / "out")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(3)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"out.{r}.npz")) for r in range(3)]


def test_replica_set_over_processes(processes, reference):
    cfg = _cfg(QWEN)
    rs = ReplicaSet(build(cfg, remat=False), 24, 3)
    st = rs.push_weights(_params(reference, "rep", cfg))
    want = rs.generate(reference["rep/prompts"], 4)
    cli = serve_cli.main(SW.REP_ARGV).tokens
    n = st["n_leaves"]
    for out in processes:
        assert out["rep/stats"].tolist() == [
            n, st["bytes"], ceil_log2(3), n * ceil_log2(3), n * ceil_log2(3)]
        np.testing.assert_array_equal(out["rep/tokens"], want)
        np.testing.assert_array_equal(out["rep/tokens"],
                                      reference["rep/tokens"])
        np.testing.assert_array_equal(out["rep/cli"], cli)


def test_ep_serving_over_processes(processes, reference):
    eng, _ = _ep_engine(reference)
    prompts = reference["ep/prompts"]
    want = torch.stack(SW.ep_logits(eng, prompts,
                                    reference["ep/logits"].shape[0]))
    cli = serve_cli.main(SW.EP_ARGV).tokens
    for out in processes[:2]:
        np.testing.assert_array_equal(out["ep/logits"], want.numpy())
        np.testing.assert_array_equal(out["ep/tokens"],
                                      reference["ep/tokens"])
        np.testing.assert_array_equal(out["ep/cli"], cli)


def test_scheduler_over_ep_engine_over_processes(processes, reference):
    eng, _ = _ep_engine(reference)
    want = SW.scheduled(eng, reference["ep/sched_prompts"])
    cli = serve_cli.main(SW.SCHED_ARGV).tokens
    for out in processes[:2]:
        for i, toks in enumerate(want):
            np.testing.assert_array_equal(out[f"sched/{i}"], toks)
            np.testing.assert_array_equal(out[f"sched/{i}"],
                                          reference[f"ep/sched_tokens_{i}"])
        for b, toks in cli.items():
            np.testing.assert_array_equal(out[f"ep/cli_sched_{b}"], toks)


def test_serve_modules_communicate_only_through_the_plan_layer():
    """The reference's ``serve-collectives-via-plan`` lint rule, kept for
    the port: no module of ``repro_torch/serve`` calls a communicator's
    exchange or native collective itself."""
    import ast
    import pathlib
    raw = {"shift", "permute", "post", "all_reduce_sum", "all_gather",
           "all_to_all", "reduce_scatter_sum"}
    pkg = pathlib.Path(HERE).parent / "src" / "repro_torch" / "serve"
    found = []
    for path in sorted(pkg.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in raw:
                found.append(f"{path.name}:{node.lineno} {node.func.attr}")
    assert not found, found
