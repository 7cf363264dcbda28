"""xLSTM-125M  [arXiv:2405.04517; unverified]
12L d_model=768 4H d_ff=0 vocab=50304 — alternating sLSTM + mLSTM blocks.
A copy of ``repro/configs/xlstm_125m.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm_xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    mlstm_chunk=256,
)
