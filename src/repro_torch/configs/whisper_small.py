"""Whisper-small  [arXiv:2212.04356; unverified]
12L enc + 12L dec, d_model=768 12H d_ff=3072 vocab=51865 — conv frontend
stubbed to precomputed frame embeddings (assignment spec).
A copy of ``repro/configs/whisper_small.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51865,
    dec_len=448,
)
