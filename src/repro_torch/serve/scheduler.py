"""Continuous-batching request scheduler over the paged KV cache, ported
from ``repro/serve/scheduler.py``.

An iteration-level scheduler: at EVERY decode-step boundary, finished
requests are evicted (their blocks go back to the free list) and waiting
requests are admitted FCFS up to ``max_batch``, so a new arrival never
waits for the whole in-flight batch to drain.  Prefill and decode are
split: an admission runs its own (B=1) prefill, so long prompts never sit
inside the batched decode step in-flight requests are latency-bound on.

Parity contract: with greedy sampling, the token stream each request
receives, under any admission/eviction interleaving, is the one
``ServeEngine.generate`` gives that request alone (bitwise on the CPU;
on a card a GEMM of another batch shape may round differently).  Per-
request block tables gather to the dense view a static cache would hold
(stale rows of reused blocks get exactly zero probability), and
``decode_step`` takes per-slot (B,) positions so staggered requests each
attend at their own offset.

An expert-parallel engine (``model.ep_ranks > 0``) holds one cache per
rank it runs in this process (every rank of a ``LocalComm``, one under
torchrun), so the scheduler keeps one paged cache per rank, on the same
block tables: each rank's prefill and decode write its own.

Collectives never appear here: the engine's model owns its
communicator, and replica-level communication goes through the plan
layer (``replica.py``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .engine import ServeEngine, eos_done_mask, params_device
from .kv_cache import (BlockAllocator, OutOfBlocks, PagedKVCache,
                       blocks_per_request, scratch_table)


@dataclass
class Request:
    """One generation request and its scheduler-owned state."""

    rid: int
    tokens: np.ndarray            # (S,) prompt
    max_new_tokens: int
    eos_id: int | None = None
    # scheduler state --------------------------------------------------
    blocks: list[int] = field(default_factory=list)
    pos: int = 0                  # next decode position (prompt_len + emitted - 1)
    last_token: int = 0
    out: list[int] = field(default_factory=list)
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def emit(self, token: int) -> None:
        self.out.append(int(token))
        if len(self.out) >= self.max_new_tokens:
            self.done = True
        nxt, done = eos_done_mask(
            torch.tensor([token], dtype=torch.int32),
            torch.tensor([self.done]), self.eos_id)
        self.done = bool(done[0])
        self.last_token = int(nxt[0])


class Scheduler:
    """FCFS continuous batching on one :class:`ServeEngine`.

    ``max_batch`` bounds the decode batch; every slot's KV lives in paged
    blocks of ``kv_block_size`` rows (``engine.max_len`` must be a
    multiple).  ``num_blocks`` defaults to scratch + full occupancy.
    ``kvs`` holds one paged cache per rank of an expert-parallel engine
    (one for any other; ``kv`` is the first).  ``boundary_s`` records the
    host-clock seconds of each :meth:`step` (each ends in a device sync:
    the sampled tokens are read back)."""

    def __init__(self, engine: ServeEngine, max_batch: int,
                 kv_block_size: int, num_blocks: int | None = None):
        self.engine = engine
        self.ep_ranks = engine.model.ep_ranks
        self.max_batch = max_batch
        self.blocks_per_req = blocks_per_request(engine.max_len,
                                                 kv_block_size)
        if num_blocks is None:
            num_blocks = 1 + max_batch * self.blocks_per_req
        self.alloc = BlockAllocator(num_blocks)
        self.device = params_device(engine.params)
        self.kvs = [PagedKVCache.create(engine.model.cfg, num_blocks,
                                        kv_block_size, self.device)
                    for _ in range(max(1, self.ep_ranks))]
        self.slots: list[Request | None] = [None] * max_batch
        self.waiting: deque[Request] = deque()
        self.finished: dict[int, np.ndarray] = {}
        self._next_rid = 0
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.boundary_s: list[float] = []

    # -- request intake ----------------------------------------------------

    def submit(self, tokens: np.ndarray, max_new_tokens: int,
               eos_id: int | None = None) -> int:
        """Queue a request; returns its id (results in ``finished``)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.shape[0] + max_new_tokens > self.engine.max_len:
            raise ValueError(
                f"{tokens.shape[0]}+{max_new_tokens} exceeds cache "
                f"{self.engine.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid=rid, tokens=tokens,
                                    max_new_tokens=max_new_tokens,
                                    eos_id=eos_id))
        return rid

    @property
    def kv(self) -> PagedKVCache:
        """The (first rank's) paged cache."""
        return self.kvs[0]

    def _per_rank(self, cache) -> list:
        """An engine's cache (or an ep engine's list of caches) as a list
        over ``kvs``."""
        return cache if self.ep_ranks else [cache]

    @property
    def in_flight(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def idle(self) -> bool:
        return not self.waiting and self.in_flight == 0

    # -- the decode-boundary state machine ---------------------------------

    def _evict_finished(self) -> None:
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                self.alloc.free(req.blocks)
                req.blocks = []
                self.finished[req.rid] = np.asarray(req.out, np.int32)
                self.slots[i] = None

    def _admit(self) -> None:
        """FCFS admissions into free slots; each runs its own (B=1)
        prefill and samples its first token from the prefill logits,
        exactly as the one-shot generate loop does."""
        for i in range(self.max_batch):
            if not self.waiting or self.slots[i] is not None:
                continue
            try:
                blocks = self.alloc.alloc(self.blocks_per_req)
            except OutOfBlocks:
                return  # FCFS: later arrivals wait behind the head
            req = self.waiting.popleft()
            req.blocks = blocks
            cache, logits = self.engine.prefill_fn(
                self.engine.params,
                torch.as_tensor(req.tokens[None], device=self.device))
            for kv, c in zip(self.kvs, self._per_rank(cache)):
                if not isinstance(c, dict) or set(c) != {"k", "v"}:
                    raise NotImplementedError(
                        "paged scheduler covers attention-family caches only")
                kv.write_prefill(blocks, {"k": c["k"][:, 0],
                                          "v": c["v"][:, 0]})
            del cache
            self.n_prefills += 1
            req.pos = req.prompt_len
            req.emit(int(torch.argmax(logits[0])))
            self.slots[i] = req
            if req.done:        # 1-token request (or instant eos)
                self._evict_finished()

    def step(self) -> None:
        """One decode-step boundary: evict, admit, then one batched decode
        over all ``max_batch`` lanes (inactive lanes run against the
        scratch block and are discarded)."""
        t0 = time.perf_counter()
        self._evict_finished()
        self._admit()
        active = [r for r in self.slots if r is not None]
        if not active:
            return
        token = np.zeros((self.max_batch,), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        tables = np.stack([scratch_table(self.blocks_per_req)
                           for _ in range(self.max_batch)])
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            token[i] = req.last_token
            pos[i] = req.pos
            tables[i] = np.asarray(req.blocks, np.int32)
        dense = [kv.gather(tables) for kv in self.kvs]
        new_cache, logits = self.engine.decode_fn(
            self.engine.params, dense if self.ep_ranks else dense[0],
            torch.as_tensor(token, device=self.device),
            torch.as_tensor(pos, device=self.device))
        for kv, c in zip(self.kvs, self._per_rank(new_cache)):
            kv.write_token(tables, c, pos)
        del dense, new_cache
        self.n_decode_steps += 1
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.pos += 1
            req.emit(int(nxt[i]))
        self.boundary_s.append(time.perf_counter() - t0)

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Drive :meth:`step` until every submitted request finished (or
        ``max_steps`` boundaries elapsed); returns {rid: (n,) tokens}."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._evict_finished()
        return self.finished
