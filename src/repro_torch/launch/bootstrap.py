"""Session bootstrap, ported from ``repro/launch/bootstrap.py``: the one
place a runnable training session is built.

Resolve the arch config, pick the device, compile the step function,
initialize parameters and optimizer state, and wire the data pipeline.
The zero1 mode runs its ``dp`` ranks as virtual ranks of a
``LocalComm`` on one device; with an expert-parallel MoE config
(``moe_dispatch="ep"``) it runs a ``dp × mp`` ``LocalMesh`` fully
manual, as the reference does: every rank holds whole replicas, zero1
syncs over the data axis and the MoE dispatch exchanges over the model
axis.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); asking for ``cuda`` where there is none raises.
Checkpoint restore, the elastic runtime and serving sessions belong to
later slices (ROADMAP.md queue 1 items 11-12).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from .. import tree as T
from ..comm import LocalComm, LocalMesh, resolve_device
from ..configs import get_config
from ..data import for_model
from ..models import build, is_ep
from ..optim.adamw import AdamWConfig
from ..optim.zero1 import GradSyncConfig
from ..train import build_single, build_zero1


@dataclass
class Session:
    """Everything a training loop needs.  ``params``/``opt`` are the live
    state (:func:`run_step` advances them); for zero1 both are lists over
    ``comm.ranks``.  ``world`` is the data-parallel world (1 in single
    mode).  ``comm`` is the data axis's communicator; with expert
    parallelism ``ep_comm`` is the model axis's (both over the same
    ``dp × mp`` ranks, data-major), else ``None``."""

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
        if moe_dispatch == "rowwise":
            raise NotImplementedError("moe_dispatch='rowwise' is not ported "
                                      "yet (ROADMAP.md queue 1 item 8)")
        cfg = replace(cfg, moe_dispatch=moe_dispatch)
    return cfg


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
                  n_layers: int | None = None) -> Session:
    """Build a runnable :class:`Session` for a ``dp × mp`` mesh; zero1
    runs its ``dp`` ranks on a ``LocalComm``.  ``mp > 1`` needs an
    expert-parallel MoE config (``moe_dispatch="ep"``): the ``dp × mp``
    ranks then run on a ``LocalMesh`` (tensor parallelism is not
    ported).  ``wire_dtype="int8"`` puts the gradient reduce-scatter on
    the int8 wire, with EF-SGD residuals unless ``error_feedback=False``;
    ``compress`` is its deprecated alias.  ``use_fused_kernel`` picks the
    kernels of every collective (the sync's rounds and the dispatch's
    ``permute_rows``).  With ``init_state=False`` params/opt stay
    ``None``.  ``n_layers`` cuts the config's depth."""
    dev = resolve_device(device)
    cfg = resolve_cfg(arch, scale_down=scale_down, moe_dispatch=moe_dispatch,
                      n_layers=n_layers)
    ep = is_ep(cfg)
    if mp != 1 and not ep:
        raise NotImplementedError(
            f"mesh {dp}x{mp}: the model (tensor-parallel) axis is not ported "
            f"yet (ROADMAP.md queue 1 item 13); use {dp}x1, or a MoE arch "
            f"with --moe-dispatch ep")
    mode = mode or ("single" if dp * mp == 1 else "zero1")
    if ep and mode != "zero1":
        raise NotImplementedError(f"moe_dispatch='ep' runs in mode zero1, "
                                  f"not {mode!r}")
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps)
    pipe = for_model(cfg, seq_len=seq_len, global_batch=global_batch)
    sync = GradSyncConfig(impl=grad_sync, schedule=schedule,
                          wire_dtype=wire_dtype,
                          compress=compress,  # deprecated alias; warns
                          error_feedback=error_feedback,
                          use_fused_kernel=use_fused_kernel,
                          bucket_bytes=bucket_bytes)
    comm = ep_comm = None
    if ep:
        mesh = LocalMesh((dp, mp), ("data", "model"))
        comm, ep_comm = mesh.axis("data"), mesh.axis(cfg.ep_axis)
    model = build(cfg, ep_comm=ep_comm, use_fused_kernel=use_fused_kernel)
    if mode == "single":
        if dp != 1:
            raise ValueError(f"mode single runs one rank, got mesh {dp}x{mp}")
        built, world = build_single(model, opt_cfg), 1
    elif mode == "zero1":
        comm = comm or LocalComm(dp)
        if global_batch % dp:
            raise ValueError(f"global batch {global_batch} % dp {dp} != 0")
        built = build_zero1(model, comm, opt_cfg, sync, dev,
                            ep_world=mp if ep else None)
        world = dp
    else:
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    sess = Session(cfg=cfg, mode=mode, device=dev, comm=comm, model=model,
                   opt_cfg=opt_cfg, sync=sync, built=built, pipe=pipe,
                   world=world, ep_comm=ep_comm)
    if init_state:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen, dev)
        if mode == "zero1":
            params = [params] + [T.map_leaves(torch.clone, params)
                                 for _ in comm.ranks[1:]]
        sess.params = params
        sess.opt = built.init_opt(params)
    return sess


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
