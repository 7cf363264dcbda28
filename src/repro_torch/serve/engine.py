"""Batched serving engine, ported from ``repro/serve/engine.py``: prefill
once, then decode greedily or temperature-sampled to ``max_new_tokens``.

``ServeEngine`` runs a :class:`repro_torch.models.ModelApi`'s ``prefill``
and ``decode_step`` on the device its parameters lie on.  An
expert-parallel MoE model (built with ``ep_comm``) runs every rank of its
communicator on the same tokens with the one parameter tree, as the
reference's ``shard_map`` with every spec ``P()`` does, so the generated
tokens are those of the single-pool path's arithmetic with the ep
exchange in each MoE layer.

Temperature sampling draws from an explicit ``torch.Generator``: it
cannot reproduce ``jax.random``'s bits, only the distribution.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import tree as T
from ..models import ModelApi


def eos_done_mask(nxt: torch.Tensor, done: torch.Tensor, eos_id):
    """Advance per-request done masks for one sampled step.

    ``nxt``: (B,) int32 sampled tokens; ``done``: (B,) bool mask of
    finished requests; ``eos_id``: None (no early exit), an int, or a
    (B,) per-request id vector where ``< 0`` means "no eos for this
    row".  Finished rows keep emitting their eos token (so the output
    stays rectangular) and newly-eos rows join the mask.  Both the
    one-shot ``generate`` early exit and the scheduler's eviction run on
    this mask."""
    if eos_id is None:
        return nxt, done
    eos = torch.as_tensor(eos_id, dtype=torch.int32, device=nxt.device)
    if eos.ndim == 0:
        nxt = torch.where(done, eos, nxt)
        done = done | (nxt == eos)
    else:
        nxt = torch.where(done & (eos >= 0), eos, nxt)
        done = done | ((eos >= 0) & (nxt == eos))
    return nxt, done


def cache_bytes(cache) -> int:
    """Bytes of the tensors in a cache: a dict or list of tensors or of
    state tuples (xLSTM's per-layer states, the hybrid's Mamba state)."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    if isinstance(cache, dict):
        cache = list(cache.values())
    return sum(cache_bytes(x) for x in cache)


def params_device(params) -> torch.device:
    """The device a parameter tree lies on."""
    return T.leaves(params)[0].device


@dataclass
class ServeEngine:
    """One model replica's prefill + decode loop.

    ``timings`` holds the host-clock seconds of the last :meth:`generate`:
    ``ttft_s`` from the call to the first token on the host, ``step_s``
    between consecutive tokens on the host (each a decode step and a
    sample; every token is read back, so each interval ends in a device
    sync); and ``cache_bytes``, the size of its cache or state."""

    model: ModelApi
    params: Any
    max_len: int
    temperature: float = 0.0
    timings: dict = field(default_factory=dict)

    def prefill_fn(self, params, tokens: torch.Tensor, extras=None):
        """``(cache, last-token logits)`` of a ``(B, S)`` prompt; ``extras``
        (``frames``, ``image_embeds``: arrays or tensors) go to the
        model's prefill on the parameters' device."""
        dev = params_device(params)
        ex = {k: torch.as_tensor(v, device=dev)
              for k, v in (extras or {}).items()}
        return self.model.prefill(params, tokens, self.max_len, **ex)

    def decode_fn(self, params, cache, token: torch.Tensor, pos):
        """``(cache, logits)`` of one decode step (the cache is written in
        place)."""
        return self.model.decode_step(params, cache, token, pos)

    def generate(self, tokens: np.ndarray, max_new_tokens: int,
                 extras: dict | None = None,
                 generator: torch.Generator | None = None,
                 eos_id: int | None = None) -> np.ndarray:
        """tokens: (B, S) prompt batch -> (B, max_new_tokens) completions.

        With ``eos_id``, rows that sample it stop consuming decode steps:
        finished rows are frozen to ``eos_id`` (the output stays (B,
        max_new_tokens)) and the loop exits as soon as every row's done
        mask is set.  As in the reference, a decode step follows every
        sampled token that does not end the loop, the last one included.
        ``generator`` drives temperature sampling (default: seed 0 on the
        parameters' device)."""
        b, s = tokens.shape
        if s + max_new_tokens > self.max_len:
            raise ValueError(
                f"{s}+{max_new_tokens} exceeds cache {self.max_len}")
        dev = params_device(self.params)
        t0 = time.perf_counter()
        cache, logits = self.prefill_fn(
            self.params, torch.as_tensor(np.asarray(tokens), device=dev),
            extras)
        if self.temperature > 0 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        out, stamps = [], []
        for i in range(max_new_tokens):
            if self.temperature > 0:
                probs = torch.softmax(
                    logits.to(torch.float32) / self.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            nxt, done = eos_done_mask(nxt.to(torch.int32), done, eos_id)
            out.append(nxt.cpu().numpy())
            stamps.append(time.perf_counter())
            if eos_id is not None and bool(done.all()):
                out.extend([np.full((b,), eos_id, np.int32)]
                           * (max_new_tokens - i - 1))
                break
            cache, logits = self.decode_fn(self.params, cache, nxt, s + i)
        self.timings = {"ttft_s": stamps[0] - t0 if stamps else None,
                        "step_s": list(np.diff(stamps)),
                        "cache_bytes": cache_bytes(cache)}
        return np.stack(out, axis=1)
