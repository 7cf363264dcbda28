"""Multi-replica data-parallel serving with a broadcast weight fan-out,
ported from ``repro/serve/replica.py``.

A serving deployment runs ``replicas`` copies of the model and splits
request traffic across them.  The one collective it needs at weight-push
time is a BROADCAST of the parameters to every replica: the standalone
allgather phase of the paper's circulant construction, exposed as the
``kind="broadcast"`` plan (Träff, arXiv:2407.18004: all-broadcast in
``ceil(log2 p)`` rounds for any p, one exchange per round).

``ReplicaSet.push_weights`` cuts every parameter leaf into ``replicas``
rows over a ``LocalComm`` of that many virtual ranks (rank r holds row
r), runs the broadcast plan so that each rank reconstructs the whole
leaf, and checks that the p reconstructions are BITWISE identical before
handing one of them to every engine (the others are freed): the plan
moves payload bits untouched, so any mismatch is a routing bug, not
rounding.  Over a ``DistComm`` (one replica per process, under
torchrun) each process holds one engine and sends its own row of every
leaf; every process drew the same weights, so each reconstruction is
checked bitwise against the process's own copy, and :meth:`generate`
runs each process's share of the requests and allgathers the
completions.  All communication goes through the plan layer
(``core.collectives``); this module issues no exchange of its own.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import tree as T
from ..comm import LocalComm
from ..core import collectives as C
from ..core.plan import plan
from ..core.schedule import ceil_log2
from ..core.spec import CollectiveSpec
from ..models import ModelApi
from .engine import ServeEngine, params_device


class ReplicaSet:
    """``replicas`` data-parallel :class:`ServeEngine` copies whose
    weights arrive through the broadcast plan (``schedule``: "power2" or
    "halving" give the optimal ``ceil(log2 p)`` rounds at every p): all
    in this process over a ``LocalComm``, or with ``comm`` (a
    ``DistComm`` of ``replicas`` processes) this process's one.
    ``engines`` holds the engines of this process."""

    def __init__(self, model: ModelApi, max_len: int, replicas: int, *,
                 temperature: float = 0.0, schedule: str = "power2",
                 comm=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if comm is not None and comm.p != replicas:
            raise ValueError(f"{replicas} replicas over a communicator of "
                             f"{comm.p} ranks")
        self.replicas = replicas
        self.spec = CollectiveSpec(kind="broadcast", schedule=schedule)
        if comm is None and replicas > 1:
            comm = LocalComm(replicas)
        self.comm = comm
        self.engines = [
            ServeEngine(model=model, params=None, max_len=max_len,
                        temperature=temperature)
            for _ in (comm.ranks if comm is not None else [0])]

    # -- weight distribution -----------------------------------------------

    def _fan_out_leaf(self, leaf: torch.Tensor) -> torch.Tensor:
        """One leaf through the broadcast plan: rows over the ranks,
        all-broadcast so every rank reconstructs all rows, each
        reconstruction bitwise the rows it came from; returns one."""
        p = self.replicas
        flat = leaf.reshape(-1)
        n = flat.numel()
        pad = (-n) % p
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        rows = flat.reshape(p, -1)
        outs = C.broadcast([rows[r:r + 1] for r in self.comm.ranks],
                           self.comm, spec=self.spec)
        for r, out in zip(self.comm.ranks, outs):
            if not T.same_bits(out, rows):
                raise AssertionError(
                    f"replica {r} reconstructed different weight bits than "
                    f"the source (broadcast must be bit-exact)")
        return outs[0].reshape(-1)[:n].reshape(leaf.shape)

    def push_weights(self, params: dict) -> dict:
        """Fan ``params`` out to every replica engine; returns stats: leaf
        count, payload bytes, broadcast rounds per leaf, exchanges, and
        the seconds it took (host clock to device sync)."""
        leaves = T.flatten(params)
        if self.replicas == 1:
            for e in self.engines:
                e.params = params
            return {"n_leaves": len(leaves), "rounds": 0, "exchanges": 0}
        dev = params_device(params)
        x0 = self.comm.exchanges
        t0 = time.perf_counter()
        full = T.unflatten((path, self._fan_out_leaf(leaf))
                           for path, leaf in leaves)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        for e in self.engines:
            e.params = full
        rounds = len(plan(self.spec, p=self.replicas).ag_rounds)
        exchanges = self.comm.exchanges - x0
        if self.spec.schedule == "power2" and \
                rounds != ceil_log2(self.replicas):
            raise AssertionError(f"broadcast plan has {rounds} rounds at p="
                                 f"{self.replicas}")
        if exchanges != len(leaves) * rounds:
            raise AssertionError(f"{exchanges} exchanges for {len(leaves)} "
                                 f"leaves x {rounds} rounds")
        return {"n_leaves": len(leaves),
                "bytes": sum(x.numel() * x.element_size()
                             for x in T.leaves(full)),
                "rounds": rounds, "exchanges": exchanges, "seconds": secs}

    # -- request dispatch --------------------------------------------------

    def generate(self, tokens: np.ndarray, max_new_tokens: int,
                 eos_id: int | None = None) -> np.ndarray:
        """Split a (B, S) prompt batch round-robin across the replicas and
        reassemble the (B, max_new_tokens) completions in order (over a
        ``DistComm`` every process runs its rows and gets them all)."""
        if any(e.params is None for e in self.engines):
            raise RuntimeError("call push_weights before generate")
        b = tokens.shape[0]
        out = np.zeros((b, max_new_tokens), np.int32)
        ranks = self.comm.ranks if self.comm is not None else (0,)
        for r, eng in zip(ranks, self.engines):
            rows = list(range(r, b, self.replicas))
            if rows:
                out[rows] = eng.generate(tokens[rows], max_new_tokens,
                                         eos_id=eos_id)
        if self.comm is not None and len(ranks) < self.replicas:
            self._gather_completions(out)
        return out

    def _gather_completions(self, out: np.ndarray) -> None:
        """Fill every other process's rows of ``out`` (round-robin) with
        its completions, through the circulant allgather: each process
        sends its ``ceil(B / p)`` rows, zero-padded."""
        p, b = self.replicas, out.shape[0]
        per = -(-b // p)
        dev = params_device(self.engines[0].params)
        mine = np.zeros((per, out.shape[1]), np.int32)
        own = out[self.comm.ranks[0]::p]
        mine[:own.shape[0]] = own
        got = C.allgather([torch.as_tensor(mine, device=dev)], self.comm,
                          spec=CollectiveSpec())[0].cpu().numpy()
        for r in range(p):
            rows = out[r::p]
            rows[:] = got[r * per:r * per + rows.shape[0]]
