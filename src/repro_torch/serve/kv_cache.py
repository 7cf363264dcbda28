"""Paged KV cache, ported from ``repro/serve/kv_cache.py``: fixed-size
blocks, per-request block tables, a free-list allocator.

The one-shot engine sizes a dense ``(L, B, max_len, Hkv, dh)`` cache per
batch; a workload with staggered arrivals wastes most of it.  The paged
cache keeps ONE pool of fixed-size blocks shared by all in-flight
requests:

* :class:`BlockAllocator` — host-side free list.  Blocks freed on
  eviction are reused by later admissions; the allocator tracks the live
  set, so a double free or an alias of a live block is an error, not a
  silent corruption.
* :class:`PagedKVCache` — the device-side pool ``(L, num_blocks,
  block_size, Hkv, dh)`` and its views: ``gather`` builds the dense
  decode view from a ``(B, blocks_per_req)`` block table (rows holding
  the same tokens are bitwise a dense cache's), ``write_prefill``
  scatters one request's prefilled rows into its blocks, ``write_token``
  scatters only each slot's one decoded position back into the pool.
  The reference's mutators return a new pool; these write the pool in
  place and return it, with the same values.

Block 0 is the SCRATCH block: inactive scheduler slots point their whole
table at it, so padded decode lanes write somewhere harmless instead of
into a live request.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..models.layers import dtype_of


class OutOfBlocks(RuntimeError):
    """Raised when an admission asks for more blocks than are free (the
    scheduler treats this as "keep the request queued")."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size cache blocks.

    Block ``scratch`` (default 0) is never handed out: it is the dummy
    target of inactive batch slots.  ``alloc``/``free`` keep a live set;
    freeing a block twice, freeing scratch, or allocating a block that is
    somehow still live raises instead of aliasing.
    """

    def __init__(self, num_blocks: int, scratch: int = 0):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 scratch), got {num_blocks}")
        self.num_blocks = num_blocks
        self.scratch = scratch
        self._free = [b for b in range(num_blocks) if b != scratch]
        self._live: set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks off the free list (FIFO reuse order)."""
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, {len(self._free)} free")
        taken, self._free = self._free[:n], self._free[n:]
        clash = self._live & set(taken)
        if clash:
            raise RuntimeError(f"allocator handed out live blocks {clash}")
        self._live |= set(taken)
        return taken

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b == self.scratch:
                raise ValueError("cannot free the scratch block")
            if b not in self._live:
                raise ValueError(f"double free of block {b}")
            self._live.discard(b)
            self._free.append(b)


@dataclass
class PagedKVCache:
    """The device-side block pool."""

    k: torch.Tensor   # (L, num_blocks, block_size, Hkv, dh)
    v: torch.Tensor
    block_size: int

    @classmethod
    def create(cls, cfg, num_blocks: int, block_size: int,
               device=None) -> "PagedKVCache":
        """A zeroed pool sized from the model config (attention KV)."""
        if cfg.family == "hybrid":
            raise NotImplementedError(
                "paged KV serving does not cover the hybrid family (its "
                "mamba state is unpaged by construction)")
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                   v=torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                   block_size=block_size)

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.k.device)

    def gather(self, tables) -> dict:
        """Dense decode view for one step: ``tables`` (B, blocks_per_req),
        row b slot b's blocks in sequence order, gives the ``{"k", "v"}``
        cache of shape (L, B, blocks_per_req * block_size, Hkv, dh) that
        ``decode_step`` takes (fresh tensors, not views of the pool)."""
        idx = self._index(tables)
        b, nb = idx.shape

        def g(s):
            return s[:, idx].reshape(s.shape[0], b, nb * self.block_size,
                                     *s.shape[3:])
        return {"k": g(self.k), "v": g(self.v)}

    def write_prefill(self, blocks: Sequence[int], dense: dict
                      ) -> "PagedKVCache":
        """Scatter ONE prefilled request into its blocks.  ``dense``: its
        cache with the batch dim stripped, k/v (L, S_cap, Hkv, dh), S_cap
        == len(blocks) * block_size (prompt rows written, tail rows
        zero)."""
        idx = self._index(list(blocks))
        nb = idx.shape[0]
        for s, d in ((self.k, dense["k"]), (self.v, dense["v"])):
            s[:, idx] = d.reshape(d.shape[0], nb, self.block_size,
                                  *d.shape[2:]).to(s.dtype)
        return self

    def write_token(self, tables, dense: dict, pos) -> "PagedKVCache":
        """Scatter each slot's one decoded position back to the pool.
        ``dense``: the (L, B, S_cap, Hkv, dh) cache ``decode_step``
        returned on the gathered view; ``pos``: (B,) the positions just
        written.  Only row ``pos[b]`` of slot b moves: block ``tables[b,
        pos[b] // bs]``, offset ``pos[b] % bs``."""
        tables = np.asarray(tables, np.int64)
        pos = np.asarray(pos, np.int64)
        rows = np.arange(pos.shape[0])
        bidx = self._index(tables[rows, pos // self.block_size])
        off = self._index(pos % self.block_size)
        rows_t, pos_t = self._index(rows), self._index(pos)
        for s, d in ((self.k, dense["k"]), (self.v, dense["v"])):
            s[:, bidx, off] = d[:, rows_t, pos_t].to(s.dtype)
        return self


def blocks_per_request(max_len: int, block_size: int) -> int:
    """Block-table length covering ``max_len`` rows; requires exact
    divisibility so the gathered view's length equals the dense cache's
    (the bitwise-parity contract with one-shot generation)."""
    if max_len % block_size:
        raise ValueError(
            f"max_len {max_len} must be a multiple of kv_block_size "
            f"{block_size} (gathered view must match the dense cache)")
    return max_len // block_size


def scratch_table(blocks_per_req: int, scratch: int = 0) -> np.ndarray:
    """Block table of an INACTIVE slot: every entry the scratch block."""
    return np.full((blocks_per_req,), scratch, np.int32)
