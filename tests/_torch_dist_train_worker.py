"""Subprocess worker: one rank of the gloo process worlds of
``test_torch_dist_train.py``, each run through the train launcher's
``main(argv)`` in the environment torchrun gives a process (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

Three worlds, one after the other (a rank past a world's size exits):

* 4 ranks: ``ARGV["ep"]``, phi-3.5-MoE expert parallel on a 2x2
  ``DistMesh``; ``ARGV["tp"]``, qwen3-1.7b tensor parallel on a 2x2
  ``DistMesh`` (ZeRO-1 over data, TP over model); ``ARGV["tp_moe"]``,
  grok-1-314b fsdp_auto on it (the global dispatch's pool gathered over
  the data axis); ``ARGV["tp_hybrid"]``, hymba-1.5b tensor parallel on
  it (the Mamba heads' all-to-all of ``[x | z]``); then ``moe_ffn_ep``
  over a ``DistComm`` of the 4 ranks,
  each rank the backward of its own loss
  (:func:`moe_loss_and_grads`), and the backward of ``all_reduce_sum``
  (:func:`all_reduce_grad`);
* 3 ranks: the ZeRO-1 runs ``ARGV[name]`` for the names of
  ``ZERO1_RUNS``; then the checkpoint drill: :func:`ckpt_argv` with
  ``--fail-at-step 2`` (every step checkpointed into ``<tmp>/ck3``),
  rerun to resume at step 2, and rank 0 copies ``step_2`` to
  ``<tmp>/ck2``;
* 2 ranks: :func:`ckpt_argv` at ``--mesh 2x1`` on ``<tmp>/ck2``: the
  3-process checkpoint resumed by 2.

Each rank writes ``<tmp>/out.<rank>.npz``: per run ``<run>/loss`` and
``<run>/gnorm`` (one per step run), and after its last step this rank's
``<run>/param/<path>``, ``<run>/m/<path>``, ``<run>/v/<path>``; for the
MoE case ``moe/out``, ``moe/aux`` and ``moe/g_<leaf>``, ``moe/g_x``;
``ar/grad``.

Run: python tests/_torch_dist_train_worker.py <rank> <p4,p3,p2> <tmp>
"""
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import tree as T  # noqa: E402


def qwen(mesh: str = "3x1", steps: int = 3, batch: int = 3) -> list:
    """The launcher's argv for scaled-down qwen3-1.7b ZeRO-1."""
    return ["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
            "--mode", "zero1", "--mesh", mesh, "--steps", str(steps),
            "--seq-len", "16", "--global-batch", str(batch), "--log-every",
            "1"]


#: every launcher run of the worlds, by name
ARGV = {"exact": qwen(),
        "int8": qwen() + ["--wire-dtype", "int8"],
        "bucket": qwen() + ["--bucket-bytes", "100000"],
        "ring": qwen() + ["--grad-sync", "ring"],
        "xla": qwen() + ["--grad-sync", "xla"],
        "ep": ["--arch", "phi3.5-moe-42b-a6.6b", "--scale-down", "--device",
               "cpu", "--mode", "zero1", "--mesh", "2x2", "--moe-dispatch",
               "ep", "--steps", "3", "--seq-len", "16", "--global-batch",
               "2", "--log-every", "1"],
        "tp": qwen(mesh="2x2", batch=4),
        "tp_moe": ["--arch", "grok-1-314b", "--scale-down", "--device",
                   "cpu", "--mode", "fsdp_auto", "--mesh", "2x2", "--steps",
                   "3", "--seq-len", "16", "--global-batch", "4",
                   "--log-every", "1"],
        "tp_hybrid": ["--arch", "hymba-1.5b", "--scale-down", "--device",
                      "cpu", "--mode", "zero1", "--mesh", "2x2", "--steps",
                      "3", "--seq-len", "16", "--global-batch", "4",
                      "--log-every", "1"]}
ZERO1_RUNS = ("exact", "int8", "bucket", "ring", "xla")


def ckpt_argv(mesh: str, ckpt_dir: str) -> list:
    """The checkpoint drill's argv: 4 steps at global batch 6 (p = 3 and
    p' = 2), every step checkpointed into ``ckpt_dir``."""
    return qwen(mesh, steps=4, batch=6) + ["--ckpt-dir", ckpt_dir,
                                           "--ckpt-every", "1"]


#: the MoE case: experts, capacity factor, tokens per rank (B, S)
MOE = dict(n_experts=5, capacity_factor=1.0, batch=2, seq=6)


def moe_inputs(p: int):
    """The MoE case's config and every rank's parameters, input and
    cotangent, drawn from ``default_rng(11)`` (each rank's parameters
    differ, so the cross-rank terms of the backward matter)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(
        get_config("phi3.5-moe-42b-a6.6b").scaled_down(),
        n_experts=MOE["n_experts"], capacity_factor=MOE["capacity_factor"],
        moe_dispatch="ep")
    rng = np.random.default_rng(11)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    ps = [{k: (rng.standard_normal(s) * 0.2).astype(np.float32)
           for k, s in shapes.items()} for _ in range(p)]
    xs = [rng.standard_normal((MOE["batch"], MOE["seq"], d)).astype(
        np.float32) for _ in range(p)]
    ws = [rng.standard_normal(x.shape).astype(np.float32) for x in xs]
    return cfg, ps, xs, ws


def moe_loss_and_grads(comm, ranks):
    """``moe_ffn_ep`` over ``comm`` for the local ``ranks``: per rank
    ``(out, aux, grads of its leaves, grad of its input)``, the grads
    from one backward of the local ranks' summed losses ``sum(out · w) +
    aux`` (``value_and_grad_ranks``)."""
    from repro_torch.models import dispatch
    from repro_torch.models.registry import value_and_grad_ranks
    cfg, ps, xs, ws = moe_inputs(comm.p)
    got = {}

    def loss_ranks(trees, batches):
        outs, auxs = dispatch.moe_ffn_ep([t["p"] for t in trees], cfg,
                                         [t["x"] for t in trees], comm)
        got["out"], got["aux"] = outs, auxs
        return [(o * b["w"]).sum() + a
                for o, a, b in zip(outs, auxs, batches)]

    trees = [{"p": {k: torch.from_numpy(v) for k, v in ps[r].items()},
              "x": torch.from_numpy(xs[r])} for r in ranks]
    batches = [{"w": torch.from_numpy(ws[r])} for r in ranks]
    _, grads = value_and_grad_ranks(loss_ranks)(trees, batches)
    return [(got["out"][j].detach(), got["aux"][j].detach(), g)
            for j, g in enumerate(grads)]


def all_reduce_grad(comm, ranks):
    """Each local rank's gradient of ``sum_r sum(all_reduce_sum(x)_r *
    w_r)`` with respect to its ``x_r`` (rank r's ``x`` and ``w`` from
    ``default_rng(12)``): one backward over the local ranks."""
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((comm.p, 6)).astype(np.float32)
    ws = rng.standard_normal((comm.p, 6)).astype(np.float32)
    x = [torch.from_numpy(xs[r]).requires_grad_(True) for r in ranks]
    ys = comm.all_reduce_sum(x)
    sum((y * torch.from_numpy(ws[r])).sum()
        for y, r in zip(ys, ranks)).backward()
    return [t.grad.numpy() for t in x]


def record(out: dict, name: str):
    """An ``on_step`` hook filling ``out`` with ``name``'s per-step loss
    and grad norm and this rank's state (after the last step, once the
    run ends)."""
    def hook(step, sess, metrics):
        for key, val in (("loss", metrics["loss"]),
                         ("gnorm", metrics["grad_norm"])):
            out.setdefault(f"{name}/{key}", []).append(float(val))
        for tag, tree in (("param", sess.params[0]), ("m", sess.opt[0].m),
                          ("v", sess.opt[0].v)):
            for path, leaf in T.flatten(tree):
                out[f"{name}/{tag}/" + "/".join(map(str, path))] = \
                    leaf.detach().float().numpy().copy()
    return hook


def join(rank: int, world: int, port: str) -> None:
    """Enter the environment torchrun gives rank ``rank`` of ``world``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)


def leave() -> None:
    import torch.distributed as dist
    dist.destroy_process_group()


def main(rank: int, ports: str, tmp: str) -> None:
    import torch.distributed as dist
    from repro_torch.comm import DistComm
    from repro_torch.ft import SimulatedFailure
    from repro_torch.launch import train
    torch.set_num_threads(1)
    p4, p3, p2 = ports.split(",")
    out: dict = {}
    join(rank, 4, p4)
    train.main(ARGV["ep"], on_step=record(out, "ep"))
    train.main(ARGV["tp"], on_step=record(out, "tp"))
    train.main(ARGV["tp_moe"], on_step=record(out, "tp_moe"))
    train.main(ARGV["tp_hybrid"], on_step=record(out, "tp_hybrid"))
    [(o, a, g)] = moe_loss_and_grads(DistComm(), [rank])
    out["moe/out"], out["moe/aux"] = o.numpy(), a.numpy()
    for k, v in g["p"].items():
        out[f"moe/g_{k}"] = v.numpy()
    out["moe/g_x"] = g["x"].numpy()
    out["ar/grad"] = all_reduce_grad(DistComm(), [rank])[0]
    leave()
    if rank < 3:
        join(rank, 3, p3)
        for name in ZERO1_RUNS:
            train.main(ARGV[name], on_step=record(out, name))
        ck3, ck2 = os.path.join(tmp, "ck3"), os.path.join(tmp, "ck2")
        argv = ckpt_argv("3x1", ck3)
        try:
            train.main(argv + ["--fail-at-step", "2"],
                       on_step=record(out, "fail"))
            raise AssertionError("no failure injected")
        except SimulatedFailure:
            pass
        if rank == 0:
            shutil.copytree(os.path.join(ck3, "step_2"),
                            os.path.join(ck2, "step_2"))
        dist.barrier()
        train.main(argv, on_step=record(out, "resume"))
        leave()
    if rank < 2:
        join(rank, 2, p2)
        train.main(ckpt_argv("2x1", os.path.join(tmp, "ck2")),
                   on_step=record(out, "resume2"))
        leave()
    np.savez(os.path.join(tmp, f"out.{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
