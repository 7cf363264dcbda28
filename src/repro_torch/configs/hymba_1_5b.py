"""Hymba-1.5B  [arXiv:2411.13676; hf]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + mamba heads; SWA everywhere except 3 global layers
(first / middle / last, Hymba recipe).
A copy of ``repro/configs/hymba_1_5b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2,
    sliding_window=1024, global_attn_layers=(0, 15, 31),
)
