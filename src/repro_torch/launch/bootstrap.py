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
:func:`params_whole`, :func:`opt_flat` and :func:`restore_session`
carry a session's state through a checkpoint (``repro_torch.checkpoint``)
in the reference's global layout: the whole leaves, and the
optimizer's arrays as the reference's ``np.asarray`` gives them
(zero1's moments padded for the data world, its EF residuals one row a
data rank; fsdp_auto's whole moments), whatever the ``D × M`` mesh and
mode that wrote them, so a checkpoint restores on any mesh and mode the
reference's ``restore_session`` restores it on (the data world resized,
each rank's blocks cut).  :func:`build_serve_session`
assembles the serving stack on the same config resolution instead: a
:class:`repro_torch.serve.ReplicaSet` of engines (expert parallel over
a ``LocalComm`` for a MoE arch with ``moe_dispatch="ep"``) with the
initial weights fanned out over the ``kind="broadcast"`` plan.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, NamedTuple

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
from ..optim.zero1 import (GradSyncConfig, Zero1State, is_zero_leaf,
                           local_rows, padded_rows, resize_zero1_state,
                           tp_sync_layout)
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
    tensor-parallel session's layout), each a copy of its own: the
    inverse of :func:`params_whole`."""
    per_leaf = [(path, sess.tp.blocks(path, x))
                for path, x in T.flatten(params)]
    return [T.unflatten((path, b[j]) for path, b in per_leaf)
            for j in range(len(sess.comm.ranks))]


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
# Checkpoint form of a session's state: the reference's global arrays
# ---------------------------------------------------------------------------

class _Leaf(NamedTuple):
    """One leaf of a session's state as a checkpoint sees it: its
    ``whole`` shape, the shape its zero1 sync sees on a rank (``sync``:
    the rank's block, or the whole leaf), and its ``LeafLayout`` where
    the ranks hold blocks of it (``ll``; ``None``: whole leaves)."""
    path: tuple
    whole: tuple
    sync: tuple
    ll: Any

    @property
    def state_blocked(self) -> bool:
        """Are the rank's optimizer moments (and EF) of a block?"""
        return self.ll is not None and self.sync != self.whole


def _leaves(sess: Session) -> list[_Leaf]:
    """Every leaf of ``sess``'s parameters, flatten order."""
    shapes = T.flatten(param_shapes(sess.cfg))
    if sess.tp is None:
        return [_Leaf(path, tuple(s), tuple(s), None) for path, s in shapes]
    lls = T.leaves(sess.tp.layout.leaves)
    if sess.mode == "zero1":
        _, sync = tp_sync_layout(sess.tp.layout, sess.world, sess.sync)
    else:  # fsdp_auto: the moments are the parameters' blocks
        sync = [ll.block for ll in lls]
    return [_Leaf(path, tuple(s), tuple(y), ll)
            for (path, s), y, ll in zip(shapes, sync, lls)]


def _model_comm(sess: Session):
    """The model axis's communicator (tensor or expert parallel), else
    ``None``."""
    return sess.tp.axis.comm if sess.tp is not None else sess.ep_comm


def _coords(sess: Session) -> list[dict]:
    """Every local rank's mesh coordinates, ``{"data": d, "model": m}``."""
    mc = _model_comm(sess)
    models = mc.ranks if mc is not None else [0] * len(sess.comm.ranks)
    return [{"data": d, "model": m} for d, m in zip(sess.comm.ranks, models)]


def _every_rank(sess: Session, xs: list, data: bool = True,
                model: bool = True) -> list | None:
    """The ranks' tensors, ``xs`` holding the local ranks' (one each), as
    ``(coords, tensor)`` pairs in the mesh's data-major rank order, on
    the session's device: the local ranks' in the in-process world.  In
    a process world (each process takes part) the circulant allgather
    brings them over the data axis where they differ along it
    (``data``), then over the model axis (``model``); along an axis where
    they agree the lead process keeps its own (data 0, model 0).  The
    lead process gets the pairs, the others ``None``."""
    if sess.proc is None:
        return [(c, x.detach()) for c, x in zip(_coords(sess), xs)]
    spec = CollectiveSpec(schedule=sess.sync.schedule)
    got = xs[0].detach()[None]
    d = m = 1
    if data and sess.comm.p > 1:
        d = sess.comm.p
        got = C.allgather([got.contiguous()], sess.comm, spec=spec)[0]
    mc = _model_comm(sess)
    if model and mc is not None and mc.p > 1:
        m = mc.p
        got = C.allgather([got.contiguous()], mc, spec=spec)[0]  # model-major
    if not sess.lead:
        return None
    return [({"data": i, "model": j}, got[j * d + i])
            for i in range(d) for j in range(m)]


def _whole(sess: Session, leaf: _Leaf, pairs: list,
           blocked: bool) -> torch.Tensor:
    """The whole leaf from its ranks' tensors (``pairs``): assembled from
    the blocks (``blocked``), else the first rank's (model column 0: of
    an expert-parallel session's replicas, the copy the reference's
    ``np.asarray`` reads)."""
    if not blocked:
        return pairs[0][1]
    out = pairs[0][1].new_empty(leaf.whole)
    for c, x in pairs:
        shd.leaf_block(out, leaf.ll, sess.tp.layout.mesh, c,
                       copy=False).copy_(x)
    return out


def _unshard(sess: Session, leaf: _Leaf, pairs: list) -> list:
    """A zero1 moment's ``sync``-shaped array of every model column, from
    its ranks' shards (``pairs``): the data ranks' rows joined and the
    padding dropped (a leaf kept whole over the data axis: data rank
    0's)."""
    zero = sess.sync.use_zero and is_zero_leaf(leaf.sync, sess.world,
                                               sess.sync.min_shard_numel)
    cols: dict = {}
    for c, x in pairs:
        cols.setdefault(c["model"], []).append(x)
    return [({"data": 0, "model": mc},
             torch.cat(xs)[:leaf.sync[0]] if zero else xs[0])
            for mc, xs in sorted(cols.items())]


def _global_rows(sess: Session, leaf: _Leaf, x: torch.Tensor) -> np.ndarray:
    """A whole zero1 moment in the reference's global layout: a zero leaf
    (at the whole shape) padded to ``(ld_pad, *rest)``."""
    if sess.sync.use_zero and is_zero_leaf(leaf.whole, sess.world,
                                           sess.sync.min_shard_numel):
        pad = padded_rows(leaf.whole[0], sess.world) - leaf.whole[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *leaf.whole[1:]))])
    return to_host(x)


def _split(leaf: _Leaf) -> tuple[bool, bool]:
    """Do the ranks' blocks of a parameter leaf (and, in fsdp_auto, of its
    moments) differ along the data axis, and along the model axis?"""
    ll = leaf.ll
    return (ll is not None and ll.data is not None,
            ll is not None and ll.model_dim is not None)


def params_whole(sess: Session) -> dict | None:
    """The session's whole parameter tree on the host, as a checkpoint
    stores it: assembled from the ranks' blocks with tensor parallelism
    (on the device, a leaf at a time), else rank 0's (model column 0 of
    an expert-parallel session).  In a process world every process must
    call it (the blocks come through the allgathers); the lead process
    gets the tree, the others ``None``."""
    if sess.mode == "single":
        return sess.params
    out, ranks = [], [T.leaves(p) for p in sess.params]
    for i, leaf in enumerate(_leaves(sess)):
        pairs = _every_rank(sess, [r[i] for r in ranks], *_split(leaf))
        if pairs is not None:
            out.append((leaf.path, _whole(sess, leaf, pairs,
                                          leaf.ll is not None).cpu()))
    return T.unflatten(out) if sess.lead else None


def opt_flat(sess: Session) -> dict | None:
    """Checkpoint form of the optimizer state: the reference's GLOBAL host
    arrays keyed ``leaf_<i>`` in its flatten order (the same keys,
    shapes, dtypes and bytes as the reference's ``np.asarray`` of each
    leaf of the same state): every ``m`` leaf, every ``v`` leaf, ``step``
    (int32), then in zero1 every EF residual leaf.

    Whatever the ``D × M`` mesh and mode, each array is of the whole
    leaf.  In zero1 a zero leaf (by the reference's rule at its WHOLE
    shape and the data world ``D``) is stored ``(ld_pad, *rest)``, a
    tiny one whole, its EF residuals ``(D, *leaf)`` (a tiny leaf's
    ``(1, *leaf)`` dummy): the ranks' shards are joined over the data
    axis (a rank's shard is of its block where tensor parallelism syncs
    blocks: its rows and flags are the block's, so the block is gathered
    whole and padded by the whole leaf's rule), and the blocks over the
    model axis.  fsdp_auto stores each whole ``m`` and ``v``.  An
    expert-parallel session's model columns each keep their own replica:
    column 0's is stored, the copy the reference's ``np.asarray`` reads.
    :func:`restore_session` restores it on any mesh.  In a process world
    every process must call it (the shards come through the allgathers);
    the lead process gets the arrays, the others ``None``."""
    if sess.mode == "single":
        o = sess.opt
        leaves = ([to_host(x) for x in T.leaves(o.m)]
                  + [to_host(x) for x in T.leaves(o.v)]
                  + [np.asarray(o.step, np.int32)])
        return {f"leaf_{i}": x for i, x in enumerate(leaves)}
    opts = sess.opt
    plan = _leaves(sess)
    fsdp = sess.mode == "fsdp_auto"

    def zero(shape):  # are a zero1 leaf's moments sharded over data?
        return sess.sync.use_zero and is_zero_leaf(
            shape, sess.world, sess.sync.min_shard_numel)

    def moments(trees):
        out, ranks = [], [T.leaves(t) for t in trees]
        for i, leaf in enumerate(plan):
            xs = [r[i] for r in ranks]
            if fsdp:
                pairs = _every_rank(sess, xs, *_split(leaf))
                if pairs is not None:
                    out.append(to_host(_whole(sess, leaf, pairs, True)))
                continue
            pairs = _every_rank(sess, xs, zero(leaf.sync),
                                leaf.state_blocked)
            if pairs is not None:
                cols = _unshard(sess, leaf, pairs)
                out.append(_global_rows(sess, leaf, _whole(
                    sess, leaf, cols, leaf.state_blocked)))
        return out

    leaves = (moments([o.m for o in opts]) + moments([o.v for o in opts])
              + [np.asarray(opts[0].step, np.int32)])
    if not fsdp and opts[0].ef is not None:
        ranks = [T.leaves(o.ef) for o in opts]
        for i, leaf in enumerate(plan):
            n = sess.world if is_zero_leaf(
                leaf.whole, sess.world, sess.sync.min_shard_numel) else 1
            pairs = _every_rank(sess, [r[i] for r in ranks], n > 1,
                                leaf.state_blocked)
            if pairs is None:
                continue
            rows = []
            for d in range(n):
                mine = [(c, x) for c, x in pairs if c["data"] == d]
                rows.append(_whole(sess, leaf, mine, leaf.state_blocked))
            leaves.append(to_host(torch.stack(rows)))
    if not sess.lead:
        return None
    return {f"leaf_{i}": x for i, x in enumerate(leaves)}


def _saved_kind(n: int, n_leaves: int) -> str:
    return {2 * n_leaves + 1: "moments",
            3 * n_leaves + 1: "moments and EF residuals"}.get(
                n, f"{n} arrays")


def restore_session(sess: Session, mgr, step: int | None = None
                    ) -> tuple[int, dict]:
    """Restore ``mgr``'s checkpoint into ``sess``; returns
    ``(resumed_step, manifest)``.

    The checkpoint holds the reference's GLOBAL arrays (see
    :func:`opt_flat`), whatever mesh and mode wrote it, so it restores on
    any ``D′ × M′`` mesh and mode the reference's ``restore_session``
    restores it on, to the same global state: in zero1 the state is
    rebuilt at the saved data world and, where that differs from
    ``D′``, put through ``resize_zero1_state``; then each local rank's
    part is cut on the host (``sharding.leaf_block`` for its blocks;
    in zero1 the data rank's rows of them, or of the whole leaf where
    the sync sees it whole) and moved to the session's device.  In a
    process world every process reads the checkpoint and cuts its own
    rank's.  Refused, with a message, as the reference cannot restore
    them: a checkpoint whose arrays do not match the session's sync (EF
    residuals or not) and one whose arrays do not have the shapes the
    session's mode takes (a zero1 state whose rows are padded for a
    data world, restored whole in single or fsdp_auto mode, or on the
    same world into zero1 leaves that need padding).  ``sess.params``
    may be ``None`` (a session built with ``init_state=False``)."""
    template = T.unflatten(
        (path, torch.empty(shape, dtype=leaf_dtype(sess.cfg, path),
                           device="meta"))
        for path, shape in T.flatten(param_shapes(sess.cfg)))
    s, params, opt_arrs, man = mgr.restore(step, template,
                                           device=torch.device("cpu"))
    del template
    plan = _leaves(sess)
    n_leaves = len(plan)
    ef = sess.mode == "zero1" and sess.sync.uses_error_feedback
    n = sum(1 for k in opt_arrs if k.startswith("leaf_"))
    want = 2 * n_leaves + 1 + (n_leaves if ef else 0)
    if n != want:
        raise ValueError(
            f"checkpoint has {n} optimizer leaves, session expects {want} "
            f"— sync/arch mismatch? (it holds {_saved_kind(n, n_leaves)}, "
            f"the session's {sess.mode} sync takes "
            f"{_saved_kind(want, n_leaves)})")
    leaves = [opt_arrs.pop(f"leaf_{i}") for i in range(n)]
    paths = [leaf.path for leaf in plan]

    def tree(lo):
        return T.unflatten(zip(paths, leaves[lo:lo + n_leaves]))

    m, v, st = tree(0), tree(n_leaves), int(leaves[2 * n_leaves])
    efs = tree(2 * n_leaves + 1) if ef else None
    del leaves
    zero1 = sess.mode == "zero1"
    if zero1 and int(man.get("world", sess.world)) != sess.world:
        state = resize_zero1_state(Zero1State(m=m, v=v, step=st, ef=efs),
                                   params, sess.world, sess.sync)
        m, v, efs = state.m, state.v, state.ef
        del state
    flags = [zero1 and sess.sync.use_zero and is_zero_leaf(
        leaf.whole, sess.world, sess.sync.min_shard_numel) for leaf in plan]
    for leaf, flag in zip(plan, flags):
        rows = padded_rows(leaf.whole[0], sess.world) if flag else None
        want_mv = (rows, *leaf.whole[1:]) if flag else leaf.whole
        for name, arr in (("m", T.get(m, leaf.path)),
                          ("v", T.get(v, leaf.path))):
            if tuple(arr.shape) != tuple(want_mv):
                raise ValueError(
                    f"checkpoint's {name} of {'.'.join(map(str, leaf.path))}"
                    f" is {tuple(arr.shape)}, the session's {sess.mode} "
                    f"state on data world {sess.world} takes "
                    f"{tuple(want_mv)}: the reference cannot restore it "
                    f"either (rows padded for a data world of "
                    f"{man.get('world')}, restored whole?)")
        if efs is not None:
            want_ef = ((sess.world if flag else 1), *leaf.whole)
            if tuple(T.get(efs, leaf.path).shape) != want_ef:
                raise ValueError(
                    f"checkpoint's EF residuals of "
                    f"{'.'.join(map(str, leaf.path))} are "
                    f"{tuple(T.get(efs, leaf.path).shape)}, the session "
                    f"takes {want_ef}")
    dev = sess.device

    def on_dev(x):  # one host-to-device copy of a stored array
        x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        return x.to(dev)

    def own(x):  # a copy of its own: ranks never share a tensor
        return x.clone(memory_format=torch.contiguous_format)

    if sess.mode == "single":
        sess.params = T.map_leaves(lambda x: own(on_dev(x)), params)
        sess.opt = TreeAdamState(m=T.map_leaves(lambda x: own(on_dev(x)), m),
                                 v=T.map_leaves(lambda x: own(on_dev(x)), v),
                                 step=st)
        return s, man
    coords = _coords(sess)

    def block(leaf, x, c, blocked):  # rank c's block of the whole x (a view)
        return shd.leaf_block(x, leaf.ll, sess.tp.layout.mesh, c,
                              copy=False) if blocked else x

    def moment(leaf, x, c):  # rank c's part of a whole moment
        if not zero1:  # fsdp_auto: the rank's block
            return own(block(leaf, x, c, True))
        x = block(leaf, x, c, leaf.state_blocked)
        if sess.sync.use_zero and is_zero_leaf(leaf.sync, sess.world,
                                               sess.sync.min_shard_numel):
            x = local_rows(x, c["data"], sess.world)
        return own(x)

    # a leaf at a time: each stored array crosses to the device once and
    # every local rank's part is cut there
    parts = {k: [[] for _ in coords] for k in ("p", "m", "v", "ef")}
    for leaf, flag in zip(plan, flags):
        x = on_dev(T.get(params, leaf.path))
        for j, c in enumerate(coords):
            parts["p"][j].append((leaf.path, own(block(
                leaf, x, c, leaf.ll is not None))))
        for k, tree_ in (("m", m), ("v", v)):
            x = on_dev(T.get(tree_, leaf.path))
            x = x[:leaf.whole[0]] if flag else x
            for j, c in enumerate(coords):
                parts[k][j].append((leaf.path, moment(leaf, x, c)))
        if efs is not None:
            e = T.get(efs, leaf.path)
            for d in sorted({c["data"] for c in coords}):
                x = on_dev(e[d if flag else 0])
                for j, c in enumerate(coords):
                    if c["data"] == d:
                        parts["ef"][j].append((leaf.path, own(block(
                            leaf, x, c, leaf.state_blocked))))
        del x
    new_p = [T.unflatten(ps) for ps in parts["p"]]
    if zero1:
        new_o = [Zero1State(m=T.unflatten(mj), v=T.unflatten(vj), step=st,
                            ef=T.unflatten(ej) if efs is not None else None)
                 for mj, vj, ej in zip(parts["m"], parts["v"], parts["ef"])]
    else:
        new_o = [TreeAdamState(m=T.unflatten(mj), v=T.unflatten(vj), step=st)
                 for mj, vj in zip(parts["m"], parts["v"])]
    del parts
    sess.params, sess.opt = new_p, new_o
    return s, man
