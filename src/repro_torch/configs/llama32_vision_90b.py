"""Llama-3.2-Vision-90B  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 — cross-attn image
layers every 5th layer; patch embeddings stubbed (assignment spec).
A copy of ``repro/configs/llama32_vision_90b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    cross_attn_every=5, n_image_tokens=4096,
    rope_theta=500_000.0,
)
