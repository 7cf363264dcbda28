"""Subprocess worker: one rank of the gloo process worlds of
``test_torch_serve_mesh.py``, in the environment torchrun gives a
process (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  Reads the reference's weights and prompts from
``<ref.npz>`` (``_torch_serve_ref.py``'s output).

* 3 ranks: ``ReplicaSet(3)`` over a ``DistComm``, one replica a
  process, the reference's ``rep/`` weights pushed through the broadcast
  plan (``rep/stats``: leaves, bytes, rounds, exchanges, and the
  communicator's exchanges) and its round-robin ``rep/tokens``; then the
  serve launcher's ``REP_ARGV`` (``rep/cli``);
* 2 ranks: the ep engine at pe = 2 over a ``DistComm`` with the
  reference's ``ep/`` weights: ``ep/logits`` of the prefill and every
  decode step of the greedy loop, ``ep/tokens`` from ``generate``; the
  scheduler over that engine on the reference's ``ep/sched_prompts``
  (``sched/<i>``); the
  serve launcher's ``EP_ARGV`` and ``EP_ARGV`` with ``--max-batch``
  (``ep/cli``, ``ep/cli_sched_<b>``).

Each rank writes ``<out>.<rank>.npz``.

Run: python tests/_torch_dist_serve_worker.py <rank> <p3,p2> <ref.npz> <out>
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

QWEN, PHI = "qwen3-1.7b", "phi3.5-moe-42b-a6.6b"
#: the reference's scheduler requests' new tokens (_torch_serve_ref.py)
SCHED_NEW = (4, 2, 3)
REP_ARGV = ["--arch", QWEN, "--scale-down", "--device", "cpu", "--batch",
            "5", "--prompt-len", "8", "--max-new", "4", "--replicas", "3"]
EP_ARGV = ["--arch", PHI, "--scale-down", "--device", "cpu", "--batch", "3",
           "--prompt-len", "8", "--max-new", "4", "--moe-dispatch", "ep",
           "--ep-devices", "2"]
SCHED_ARGV = EP_ARGV + ["--max-batch", "2", "--kv-block-size", "4"]


def cfg_of(name, **kw):
    """The scaled-down config the reference's serving worker uses."""
    return get_config(name).scaled_down(n_layers=2, vocab_size=64, **kw)


def ref_params(ref, prefix, cfg):
    """The reference's ``<prefix>/param/<dotted path>`` weights, in the
    port's layout."""
    tag = f"{prefix}/param/"
    tree = T.unflatten((tuple(k[len(tag):].split(".")), v)
                       for k, v in ref.items() if k.startswith(tag))
    return params_from_numpy(tree, cfg)


def ep_engine(ref, comm):
    """The ep engine at pe = 2 over ``comm`` with the reference's
    weights (max_len 16, as the reference's)."""
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    cfg = cfg_of(PHI, moe_dispatch="ep")
    model = build(cfg, remat=False, ep_comm=comm)
    return ServeEngine(model, ref_params(ref, "ep", cfg), 16)


def ep_logits(eng, prompts, new):
    """The logits of the prefill and of each greedy decode step after it
    (``new`` calls in all), this process's first rank's."""
    caches, logits = eng.prefill_fn(eng.params, torch.as_tensor(prompts))
    out = []
    for i in range(new):
        out.append(logits)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        caches, logits = eng.decode_fn(eng.params, caches, nxt,
                                       prompts.shape[1] + i)
    return out


def scheduled(eng, prompts):
    """The scheduler over ``eng`` (2 slots, blocks of 8) on ``prompts``
    with ``SCHED_NEW`` new tokens each: each request's tokens."""
    from repro_torch.serve import Scheduler
    sched = Scheduler(eng, max_batch=2, kv_block_size=8)
    rids = [sched.submit(p, n) for p, n in zip(prompts, SCHED_NEW)]
    done = sched.run()
    assert len(sched.kvs) == eng.model.ep_ranks
    return [done[r] for r in rids]


def join(rank: int, world: int, port: str) -> None:
    """Enter the environment torchrun gives rank ``rank`` of ``world``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)


def main(rank: int, ports: str, src: str, prefix: str) -> None:
    import torch.distributed as dist
    from repro_torch.comm import DistComm
    from repro_torch.launch import mesh, serve
    from repro_torch.models import build
    from repro_torch.serve import ReplicaSet
    torch.set_num_threads(1)
    ref = dict(np.load(src))
    p3, p2 = ports.split(",")
    out = {}
    if rank < 3:
        join(rank, 3, p3)
        mesh.init_world("cpu")
        comm = DistComm()
        cfg = cfg_of(QWEN)
        rs = ReplicaSet(build(cfg, remat=False), 24, 3, comm=comm)
        st = rs.push_weights(ref_params(ref, "rep", cfg))
        out["rep/stats"] = np.asarray([st["n_leaves"], st["bytes"],
                                       st["rounds"], st["exchanges"],
                                       comm.exchanges])
        out["rep/tokens"] = rs.generate(ref["rep/prompts"], 4)
        out["rep/cli"] = serve.main(REP_ARGV).tokens
        dist.destroy_process_group()
    if rank < 2:
        join(rank, 2, p2)
        mesh.init_world("cpu")
        eng = ep_engine(ref, DistComm())
        prompts = ref["ep/prompts"]
        new = ref["ep/logits"].shape[0]
        out["ep/logits"] = torch.stack(ep_logits(eng, prompts, new)).numpy()
        out["ep/tokens"] = eng.generate(prompts, new)
        for i, toks in enumerate(scheduled(eng, ref["ep/sched_prompts"])):
            out[f"sched/{i}"] = toks
        out["ep/cli"] = serve.main(EP_ARGV).tokens
        done = serve.main(SCHED_ARGV).tokens
        for b, toks in done.items():
            out[f"ep/cli_sched_{b}"] = toks
        dist.destroy_process_group()
    np.savez(f"{prefix}.{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
