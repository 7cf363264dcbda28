"""Session bootstrap, ported from ``repro/launch/bootstrap.py``: the one
place a runnable training session is built.

Resolve the arch config, pick the device, compile the step function,
initialize parameters and optimizer state, and wire the data pipeline.
The zero1 mode runs its ``dp`` ranks as virtual ranks of a
``LocalComm`` on one device; with an expert-parallel MoE config
(``moe_dispatch="ep"``) it runs a ``dp × mp`` ``LocalMesh`` fully
manual, as the reference does: every rank holds whole replicas, zero1
syncs over the data axis and the MoE dispatch exchanges over the model
axis.  A dense, MoE (global or rowwise dispatch) or VLM config on ``mp
> 1`` (or in mode ``fsdp_auto``) runs tensor parallel over the model
axis (``models/sharding.py``): the
recipe is ``ShardingRecipe(data_axes=("data",), model_axis="model",
tp_size=mp)``, in mode ``tp`` for zero1 and, for fsdp_auto, by the
reference's rule for training the largest archs (``FSDP_ARCHS``,
``repro/launch/dryrun.py:51,85-90``: ``tp_fsdp`` for them, else ``tp``,
the only place the reference says how qwen1.5-110b is sharded for
training); each rank holds its blocks of the leaves.  The numbers do not
depend on the layout, only the memory does.  Started by torchrun
(``launch.mesh.is_process_world()``), each process is one rank of that
world instead, on a card of its own (``cuda:LOCAL_RANK``, NCCL) or over
gloo on the CPU: a ``DistComm`` of the world for ``dp × 1``, a
``DistMesh`` with its data and model axes for ep and tensor
parallelism.  Every process initializes the same parameters from
``seed``, as the reference replicates them, and its lists hold its one
rank (with tensor parallelism every leaf is drawn whole and cut to the
rank's blocks).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); asking for ``cuda`` where there is none raises.
:func:`opt_flat` and :func:`restore_session` carry a session's state
through a checkpoint (``repro_torch.checkpoint``) in the reference's
global layout, across a change of world size.  :func:`build_serve_session`
assembles the serving stack on the same config resolution instead: a
:class:`repro_torch.serve.ReplicaSet` of engines (expert parallel over
a ``LocalComm`` for a MoE arch with ``moe_dispatch="ep"``) with the
initial weights fanned out over the ``kind="broadcast"`` plan.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from .. import tree as T
from ..checkpoint.manager import to_host
from ..comm import DistComm, LocalComm, LocalMesh, resolve_device
from ..core import collectives as C
from ..core.spec import CollectiveSpec
from ..configs import get_config
from ..data import for_model
from ..models import (ShardingRecipe, build, is_ep, leaf_dtype,
                      param_shapes)
from ..models import sharding as shd
from ..optim.adamw import AdamWConfig, TreeAdamState
from ..optim.zero1 import (GradSyncConfig, Zero1State, resize_zero1_state,
                           zero_flags)
from ..serve import ReplicaSet
from ..train import build_fsdp_auto, build_single, build_zero1
from . import mesh as meshlib

#: archs whose parameters cannot be replicated across data ranks: fsdp_auto
#: trains them ``tp_fsdp`` (a copy of ``repro/launch/dryrun.py:51``)
FSDP_ARCHS = {"grok-1-314b", "qwen1.5-110b", "llama-3.2-vision-90b"}


@dataclass
class Session:
    """Everything a training loop needs.  ``params``/``opt`` are the live
    state (:func:`run_step` advances them); for zero1 both are lists over
    ``comm.ranks``.  ``world`` is the data-parallel world (1 in single
    mode).  ``comm`` is the data axis's communicator; with expert
    parallelism ``ep_comm`` is the model axis's (both over the same
    ``dp × mp`` ranks, data-major), else ``None``.  With tensor
    parallelism ``tp`` is the model's ``sharding.TensorParallel`` (its
    ``axis.comm`` the model axis's communicator), else ``None``.
    ``proc`` is this process's global rank in a process world (one rank
    per process), ``None`` in the in-process world."""

    cfg: Any
    mode: str
    device: torch.device
    comm: Any
    model: Any
    opt_cfg: AdamWConfig
    sync: GradSyncConfig
    built: Any
    pipe: Any
    world: int
    params: Any = None
    opt: Any = None
    ep_comm: Any = None
    proc: int | None = None
    tp: Any = None

    @property
    def lead(self) -> bool:
        """True in the process that logs and writes checkpoints: rank 0
        of a process world, or the one process of the in-process
        world."""
        return self.proc in (None, 0)


def resolve_cfg(arch: str, *, scale_down: bool = False,
                moe_dispatch: str | None = None,
                n_layers: int | None = None):
    """Arch name to config, with the scale-down and MoE-dispatch knobs
    resolved as the reference does; ``n_layers`` cuts the depth (no CLI
    flag: for runs of a full-width config on one card)."""
    cfg = get_config(arch)
    if scale_down:
        cfg = cfg.scaled_down()
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    if moe_dispatch is not None:
        if not cfg.is_moe:
            raise ValueError(
                f"moe_dispatch given but {arch} is not a MoE arch")
        cfg = replace(cfg, moe_dispatch=moe_dispatch)
    return cfg


def join_world(n: int, device, what: str) -> torch.device:
    """Join torchrun's process world after checking that it holds the
    ``n`` ranks ``what`` asks for; returns this rank's device."""
    have = meshlib.world_size()
    if have != n:
        raise ValueError(f"{what} needs a world of {n} processes, but "
                         f"torchrun started {have} (--nproc-per-node)")
    return meshlib.init_world(device)


def build_session(*, arch: str, scale_down: bool = False, steps: int = 100,
                  seq_len: int = 128, global_batch: int = 8,
                  dp: int = 1, mp: int = 1, mode: str | None = None,
                  grad_sync: str = "circulant", schedule: str = "halving",
                  wire_dtype: str | None = None, error_feedback: bool = True,
                  compress: str | None = None,
                  use_fused_kernel: bool | None = None,
                  bucket_bytes: int | None = None,
                  moe_dispatch: str | None = None,
                  lr: float = 3e-4, warmup: int = 20,
                  device: str | torch.device = "cuda",
                  seed: int = 0, init_state: bool = True,
                  n_layers: int | None = None,
                  sequence_parallel: bool = False,
                  expand_gqa: bool = False) -> Session:
    """Build a runnable :class:`Session` for a ``dp × mp`` mesh; zero1
    runs its ``dp`` ranks on a ``LocalComm``.  ``mp > 1`` runs the
    ``dp × mp`` ranks on a ``LocalMesh``: an expert-parallel MoE config
    (``moe_dispatch="ep"``) exchanges over the model axis, any other
    config is tensor parallel over it, as is mode ``fsdp_auto`` on any
    mesh (``sequence_parallel`` and ``expand_gqa``: the recipe's
    fields).  ``grad_sync`` is the sync's impl (circulant, ring, xla or
    allreduce) and ``bucket_bytes`` its bucket size (circulant; on an
    expert-parallel mesh the buckets run over the data axis).
    ``wire_dtype="int8"`` puts the gradient reduce-scatter on the int8
    wire, with EF-SGD residuals unless ``error_feedback=False``;
    ``compress`` is its deprecated alias.  ``use_fused_kernel`` picks the
    kernels of every collective (the sync's rounds and the dispatch's
    ``permute_rows``).  With ``init_state=False`` params/opt stay
    ``None``.  ``n_layers`` cuts the config's depth.  Under torchrun
    the ``dp × mp`` ranks are the world's processes (one each)."""
    cfg = resolve_cfg(arch, scale_down=scale_down, moe_dispatch=moe_dispatch,
                      n_layers=n_layers)
    ep = is_ep(cfg)
    mode = mode or ("single" if dp * mp == 1 else "zero1")
    if mode not in ("single", "zero1", "fsdp_auto"):
        raise ValueError(f"unknown mode {mode!r}")
    if ep and mode != "zero1":
        raise NotImplementedError(f"moe_dispatch='ep' runs in mode zero1, "
                                  f"not {mode!r}")
    tensor_parallel = mode == "fsdp_auto" or (mode == "zero1" and mp != 1
                                              and not ep)
    procs = meshlib.is_process_world()
    if procs:
        dev = join_world(dp * mp, device, f"mesh {dp}x{mp}")
    else:
        dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps)
    pipe = for_model(cfg, seq_len=seq_len, global_batch=global_batch)
    sync = GradSyncConfig(impl=grad_sync, schedule=schedule,
                          wire_dtype=wire_dtype,
                          compress=compress,  # deprecated alias; warns
                          error_feedback=error_feedback,
                          use_fused_kernel=use_fused_kernel,
                          bucket_bytes=bucket_bytes)
    comm = ep_comm = tp = None
    if ep or tensor_parallel:
        mesh = (meshlib.make_mesh((dp, mp), ("data", "model")) if procs
                else LocalMesh((dp, mp), ("data", "model")))
        comm = mesh.axis("data")
    if ep:
        ep_comm = mesh.axis(cfg.ep_axis)
    if tensor_parallel:
        recipe = ShardingRecipe(
            data_axes=("data",), model_axis="model",
            mode=("tp_fsdp" if mode == "fsdp_auto" and cfg.name in FSDP_ARCHS
                  else "tp"),
            sequence_parallel=sequence_parallel, tp_size=mp,
            expand_gqa=expand_gqa)
        tp = shd.TensorParallel(
            axis=shd.ModelAxis(mesh.axis("model"), recipe), data=comm,
            layout=shd.tp_layout(cfg, recipe, (dp, mp)),
            pooled=mode == "fsdp_auto")
    model = build(cfg, ep_comm=ep_comm, use_fused_kernel=use_fused_kernel,
                  tp=tp)
    if mode == "fsdp_auto":
        if global_batch % dp:
            raise ValueError(f"global batch {global_batch} % dp {dp} != 0")
        built, world = build_fsdp_auto(model, tp, opt_cfg), dp
    elif mode == "single":
        if dp * mp != 1:
            raise ValueError(f"mode single runs one rank, got mesh {dp}x{mp}")
        built, world = build_single(model, opt_cfg), 1
    else:
        comm = comm or (DistComm() if procs else LocalComm(dp))
        if global_batch % dp:
            raise ValueError(f"global batch {global_batch} % dp {dp} != 0")
        built = build_zero1(model, comm, opt_cfg, sync, dev,
                            ep_world=mp if ep else None, tp=tp)
        world = dp
    sess = Session(cfg=cfg, mode=mode, device=dev, comm=comm, model=model,
                   opt_cfg=opt_cfg, sync=sync, built=built, pipe=pipe,
                   world=world, ep_comm=ep_comm,
                   proc=meshlib.rank() if procs else None, tp=tp)
    if init_state:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen, dev)  # per-rank blocks with tp
        if mode == "zero1" and tp is None:
            params = [params] + [T.map_leaves(torch.clone, params)
                                 for _ in comm.ranks[1:]]
        sess.params = params
        sess.opt = built.init_opt(params)
    return sess


@dataclass
class ServeSession:
    """The serving counterpart of :class:`Session`: config and engines.
    ``replica_set`` holds ``replicas`` engines whose weights came through
    the broadcast plan (``push_stats``: leaf count, payload bytes,
    rounds, exchanges, seconds); ``params`` is the tree they were pushed
    from.  ``ep_comm`` is the expert-parallel communicator MoE decode
    exchanges over (``None`` otherwise).  ``proc`` is this process's
    rank in a process world, else ``None``."""

    cfg: Any
    device: torch.device
    model: Any
    params: Any
    replica_set: Any
    ep_comm: Any
    push_stats: dict
    proc: int | None = None

    @property
    def engine(self):
        """Engine 0: the one-replica view."""
        return self.replica_set.engines[0]


def build_serve_session(*, arch: str, max_len: int, scale_down: bool = False,
                        temperature: float = 0.0,
                        moe_dispatch: str | None = None, ep_devices: int = 2,
                        replicas: int = 1, broadcast_schedule: str = "power2",
                        seed: int = 0, device: str | torch.device = "cuda",
                        n_layers: int | None = None) -> ServeSession:
    """Build the serving stack with :func:`build_session`'s config
    resolution (arch aliases, scale-down, MoE dispatch, ``n_layers``
    cut).  Weights are initialized once from ``seed`` on ``device`` and
    pushed to every replica through the ``kind="broadcast"`` plan
    (bitwise-checked fan-out).  With ``moe_dispatch="ep"`` each engine
    runs ``ep_devices`` virtual ranks of a ``LocalComm`` on the one
    parameter tree, exchanging dispatch buffers through the circulant
    alltoall (its ``permute_rows`` kernel when the buffer lies on a
    card).  Under torchrun each process is one rank: of the ep
    communicator (``ep_devices`` must equal the world), or one replica
    (``replicas`` must equal the world), the weights drawn from ``seed``
    in every process and each process sending its row of every leaf
    through the same plan."""
    cfg = resolve_cfg(arch, scale_down=scale_down, moe_dispatch=moe_dispatch,
                      n_layers=n_layers)
    ep = is_ep(cfg)
    procs = meshlib.is_process_world()
    if procs:
        if ep and replicas != 1:
            raise ValueError("under torchrun the world is either the ep "
                             "ranks or the replicas, not both")
        dev = join_world(ep_devices if ep else replicas, device,
                         f"--ep-devices {ep_devices}" if ep
                         else f"--replicas {replicas}")
        ep_comm = DistComm() if ep else None
        rep_comm = DistComm() if not ep and replicas > 1 else None
    else:
        dev = resolve_device(device)
        ep_comm = LocalComm(ep_devices) if ep else None
        rep_comm = None
    model = build(cfg, remat=False, ep_comm=ep_comm)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    rs = ReplicaSet(model, max_len, replicas, temperature=temperature,
                    schedule=broadcast_schedule, comm=rep_comm)
    stats = rs.push_weights(params)
    return ServeSession(cfg=cfg, device=dev, model=model, params=params,
                        replica_set=rs, ep_comm=ep_comm, push_stats=stats,
                        proc=meshlib.rank() if procs else None)


def shard_params(sess: Session, params: dict) -> list:
    """Every local rank's blocks of a whole parameter tree (a
    tensor-parallel session's layout), each a copy of its own."""
    per_leaf = [(path, sess.tp.blocks(path, x))
                for path, x in T.flatten(params)]
    return [T.unflatten((path, b[j]) for path, b in per_leaf)
            for j in range(len(sess.comm.ranks))]


def whole_params(sess: Session, trees: list) -> dict:
    """The whole parameter tree from every local rank's blocks (the
    in-process world, where every rank is local): the inverse of
    :func:`shard_params`."""
    lay = sess.tp.layout
    out = []
    for path, shape in T.flatten(param_shapes(sess.cfg)):
        ll = T.get(lay.leaves, path)
        full = T.get(trees[0], path).new_empty(shape)
        for tree, c in zip(trees, sess.tp.coords()):
            shd.leaf_block(full, ll, lay.mesh, c, copy=False).copy_(
                T.get(tree, path))
        out.append((path, full))
    return T.unflatten(out)


def place_batch(sess: Session, batch: dict):
    """Host batch to device tensors: the whole batch (single) or each
    local rank's slice of the global batch by its data-axis rank (zero1;
    model-axis ranks get the same slice, as the reference's batch spec
    ``P(data_axes)`` gives them)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(sess.device)

    if sess.mode == "single":
        return {k: put(v) for k, v in batch.items()}
    out = []
    for r in sess.comm.ranks:
        sl = {}
        for k, v in batch.items():
            rows = v.shape[0] // sess.world
            sl[k] = put(v[r * rows:(r + 1) * rows])
        out.append(sl)
    return out


def run_step(sess: Session, step: int) -> dict:
    """One optimizer step at ``step``'s data-cursor batch; advances
    ``sess.params`` / ``sess.opt`` and returns the metrics."""
    batch = place_batch(sess, sess.pipe.batch_at(step))
    sess.params, sess.opt, metrics = sess.built.step_fn(
        sess.params, sess.opt, batch)
    return metrics


# ---------------------------------------------------------------------------
# Checkpoint form of a session's state
# ---------------------------------------------------------------------------

def _zero_flags(sess: Session, params: dict) -> list[bool]:
    """Per leaf (flatten order): sharded at ``sess.world``?"""
    return zero_flags([tuple(p.shape) for p in T.leaves(params)],
                      sess.world, sess.sync)


def _check_gatherable(sess: Session) -> None:
    if sess.tp is not None:
        raise NotImplementedError(
            "checkpoints of a tensor-parallel or fsdp_auto session are not "
            "supported: resharding them across meshes waits for ROADMAP.md "
            "queue 1 item 11.2")
    if sess.ep_comm is not None:
        raise NotImplementedError(
            "checkpoints of an expert-parallel session are not supported: "
            "each model column keeps its own replica of the ZeRO-1 state")


def _gather_rows(sess: Session, parts: list) -> np.ndarray | None:
    """The ranks' shards stacked along dim 0, in one host array: the
    local ranks' parts in the in-process world; in a process world every
    rank's through the circulant allgather (each process takes part),
    copied to the host by the lead process only (``None`` elsewhere)."""
    if sess.proc is not None:
        full = C.allgather(list(parts), sess.comm,
                           spec=CollectiveSpec(schedule=sess.sync.schedule))
        return to_host(full[0]) if sess.lead else None
    host = torch.empty((sum(x.shape[0] for x in parts), *parts[0].shape[1:]),
                       dtype=parts[0].dtype)
    off = 0
    for x in parts:
        host[off:off + x.shape[0]].copy_(x)
        off += x.shape[0]
    return to_host(host)


def opt_flat(sess: Session) -> dict | None:
    """Checkpoint form of the optimizer state: the reference's GLOBAL host
    arrays keyed ``leaf_<i>`` in its flatten order: every ``m`` leaf,
    every ``v`` leaf, ``step`` (int32), then in zero1 every EF residual
    leaf.  In zero1 each zero leaf's ranks' ``m`` / ``v`` shards are
    gathered into the ``(ld_pad, *rest)`` array the reference stores,
    its EF residuals into ``(world, *leaf)`` (tiny leaves: rank 0's
    replica and a ``(1, *leaf)`` dummy), so :func:`restore_session` can
    restore it at any world size.  In a process world every process must
    call it (the shards come through the allgather); the lead process
    gets the arrays, the others ``None``."""
    if sess.mode == "single":
        o = sess.opt
        leaves = ([to_host(x) for x in T.leaves(o.m)]
                  + [to_host(x) for x in T.leaves(o.v)]
                  + [np.asarray(o.step, np.int32)])
        return {f"leaf_{i}": x for i, x in enumerate(leaves)}
    _check_gatherable(sess)
    opts = sess.opt
    flags = _zero_flags(sess, sess.params[0])

    def whole(x):  # a replicated leaf: the lead's copy
        return to_host(x) if sess.lead else None

    def gather(trees):
        per_rank = [T.leaves(t) for t in trees]
        return [_gather_rows(sess, [r[i] for r in per_rank]) if flag
                else whole(per_rank[0][i]) for i, flag in enumerate(flags)]

    leaves = (gather([o.m for o in opts]) + gather([o.v for o in opts])
              + [np.asarray(opts[0].step, np.int32)])
    if opts[0].ef is not None:
        per_rank = [T.leaves(o.ef) for o in opts]
        leaves += [_gather_rows(sess, [r[i][None] for r in per_rank]) if flag
                   else whole(per_rank[0][i][None])
                   for i, flag in enumerate(flags)]
    if not sess.lead:
        return None
    return {f"leaf_{i}": x for i, x in enumerate(leaves)}


def _shard(arr: np.ndarray, rank: int, world: int, device) -> torch.Tensor:
    """``rank``'s ``1/world`` rows of ``arr`` as a tensor on ``device``."""
    rows = arr.shape[0] // world
    part = np.ascontiguousarray(arr[rank * rows:(rank + 1) * rows])
    return torch.from_numpy(part).to(device, copy=True)


def restore_session(sess: Session, mgr, step: int | None = None
                    ) -> tuple[int, dict]:
    """Restore ``mgr``'s checkpoint into ``sess``, resizing across
    world-size changes; returns ``(resumed_step, manifest)``.

    The checkpoint's optimizer arrays are GLOBAL (gathered; see
    :func:`opt_flat`), so a world mismatch is handled on the host:
    rebuild the saved world's global :class:`Zero1State`, run
    ``resize_zero1_state`` to ``sess.world``, then cut each rank's shard
    and move it to the session's device.  In a process world every
    process reads the checkpoint and cuts its own rank's shard.
    ``sess.params`` may be ``None`` (a session built with
    ``init_state=False``)."""
    _check_gatherable(sess)
    if sess.params is None:
        template = T.unflatten(
            (path, torch.empty(shape, dtype=leaf_dtype(sess.cfg, path),
                               device="meta"))
            for path, shape in T.flatten(param_shapes(sess.cfg)))
    else:
        template = sess.params[0] if sess.mode == "zero1" else sess.params
    s, params, opt_arrs, man = mgr.restore(step, template,
                                           device=sess.device)
    del template
    paths = [path for path, _ in T.flatten(params)]
    n_leaves = len(paths)
    ef = sess.mode == "zero1" and sess.sync.uses_error_feedback
    n = sum(1 for k in opt_arrs if k.startswith("leaf_"))
    want = 2 * n_leaves + 1 + (n_leaves if ef else 0)
    if n != want:
        raise ValueError(
            f"checkpoint has {n} optimizer leaves, session expects {want} "
            f"— sync/arch mismatch?")
    leaves = [opt_arrs.pop(f"leaf_{i}") for i in range(n)]

    def tree(lo):
        return T.unflatten(zip(paths, leaves[lo:lo + n_leaves]))

    m, v, st = tree(0), tree(n_leaves), int(leaves[2 * n_leaves])
    efs = tree(2 * n_leaves + 1) if ef else None
    del leaves
    dev = sess.device

    def put(x):  # a copy: ranks never share a tensor
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, copy=True)

    if sess.mode == "single":
        sess.params = params
        sess.opt = TreeAdamState(m=T.map_leaves(put, m),
                                 v=T.map_leaves(put, v), step=st)
        return s, man
    state = Zero1State(m=m, v=v, step=st, ef=efs)
    del m, v, efs
    if int(man.get("world", sess.world)) != sess.world:
        state = resize_zero1_state(state, params, sess.world, sess.sync)
    flags = _zero_flags(sess, params)
    world = sess.world
    opts = []
    for r in sess.comm.ranks:
        def mv(tree):
            return T.unflatten(
                (path, _shard(x, r, world, dev) if flag else put(x))
                for (path, x), flag in zip(T.flatten(tree), flags))

        ef_r = None
        if state.ef is not None:
            ef_r = T.unflatten(
                (path, put(x[r] if flag else x[0]))
                for (path, x), flag in zip(T.flatten(state.ef), flags))
        opts.append(Zero1State(m=mv(state.m), v=mv(state.v), step=state.step,
                               ef=ef_r))
    sess.params = [params] + [T.map_leaves(torch.clone, params)
                              for _ in sess.comm.ranks[1:]]
    sess.opt = opts
    return s, man
