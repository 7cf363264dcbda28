"""Deterministic, seekable synthetic token pipeline.

Every batch is a pure function of (seed, step) — ``batch_at(step)`` —
so restart/elastic-reshard resume is exact by construction: the
checkpoint stores only the step cursor.  Host sharding: each host
materializes only its slice of the global batch (here: single host
materializes all; the slicing API is what a multi-host launcher calls).

The stream is Zipf-distributed tokens with a shifted-window structure so
the LM task is learnable (loss decreases) — used by the quickstart
example and the convergence test.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # modality extras (stubs per assignment)
    frames_dim: int = 0       # encdec: frame-embedding dim (d_model)
    frames_len: int = 0
    image_tokens: int = 0     # vlm: number of patch embeddings
    image_dim: int = 0
    dec_len: int = 0          # encdec: decoder text length


class SyntheticPipeline:
    """batch_at(step) -> dict of numpy arrays (tokens/targets [+frames/
    image_embeds]).  Learnable structure: t_{i+1} = (a * t_i + b) % V with
    per-sequence (a, b) drawn from a small set, plus noise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"batch {cfg.global_batch} % hosts {n_hosts}")
        rng = self._rng(step)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # Per-sequence affine recurrences over a reduced alphabet.
        alpha = max(2, min(v, 257))
        a = rng.choice([1, 2, 3, 5], size=(b, 1))
        c = rng.integers(1, alpha, size=(b, 1))
        t0 = rng.integers(0, alpha, size=(b, 1))
        seq = np.empty((b, s + 1), np.int64)
        seq[:, 0] = t0[:, 0]
        for i in range(s):
            seq[:, i + 1] = (a[:, 0] * seq[:, i] + c[:, 0]) % alpha
        noise = rng.random((b, s + 1)) < 0.05
        seq = np.where(noise, rng.integers(0, alpha, (b, s + 1)), seq)
        tokens = seq[:, :-1].astype(np.int32)
        targets = seq[:, 1:].astype(np.int32)
        lo = host_id * (b // n_hosts)
        hi = lo + b // n_hosts
        out = {"tokens": tokens[lo:hi], "targets": targets[lo:hi]}
        if cfg.frames_dim:
            out["frames"] = rng.standard_normal(
                (hi - lo, cfg.frames_len, cfg.frames_dim)).astype(np.float32)
        if cfg.image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (hi - lo, cfg.image_tokens, cfg.image_dim)).astype(np.float32)
        return out

    def batches(self, start_step: int = 0, host_id: int = 0, n_hosts: int = 1):
        step = start_step
        while True:
            yield step, self.batch_at(step, host_id, n_hosts)
            step += 1


def for_model(model_cfg, seq_len: int, global_batch: int,
              seed: int = 0) -> SyntheticPipeline:
    """Pipeline wired to a ModelConfig's modality extras."""
    kw = dict(vocab_size=model_cfg.vocab_size, seq_len=seq_len,
              global_batch=global_batch, seed=seed)
    if model_cfg.family == "encdec":
        kw.update(frames_dim=model_cfg.d_model, frames_len=seq_len,
                  seq_len=min(model_cfg.dec_len, seq_len),
                  dec_len=min(model_cfg.dec_len, seq_len))
    if model_cfg.family == "vlm":
        kw.update(image_tokens=model_cfg.n_image_tokens,
                  image_dim=model_cfg.d_model)
    return SyntheticPipeline(DataConfig(**kw))
