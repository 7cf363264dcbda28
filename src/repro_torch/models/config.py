"""Model configuration, ported from ``repro/models/config.py``.

One ``ModelConfig`` schema for every architecture family of the
reference (family selects the model builder in ``registry.py``).  The
dataclass is a copy of the reference's, so a config means the same
model in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm_xlstm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- attention flavor ---
    qk_norm: bool = False          # qwen3-style per-head RMS norm on q, k
    qkv_bias: bool = False         # qwen1.5-style bias on QKV projections
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full attention

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "global"   # global | rowwise (§Perf C) | ep
    #                                (expert parallel via circulant
    #                                alltoall; needs ep_axis manual)
    ep_axis: str = "model"         # mesh axis ep dispatch exchanges over

    # --- SSM / hybrid ---
    ssm_state: int = 0             # mamba state size (hymba: 16)
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_conv: int = 4              # depthwise conv kernel
    mlstm_chunk: int = 256         # chunked-parallel mLSTM chunk length
    global_attn_layers: tuple[int, ...] = ()  # hymba: full-attn layer ids

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    dec_len: int = 512             # decoder text length for enc-dec cells

    # --- VLM (llama-3.2-vision) ---
    cross_attn_every: int = 0      # every k-th layer is a cross-attn layer
    n_image_tokens: int = 0

    # --- dry-run/roofline instrumentation ---
    scan_unroll: int = 1   # unroll factor for the layer scan (two-point
    #                        HLO-cost correction; see roofline/analysis.py)
    remat_policy: str = "nothing"  # nothing | dots  (§Perf D: 'dots' saves
    #                                matmul/collective outputs so the remat
    #                                pass doesn't repeat fwd TP collectives)

    # --- numerics ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, \
            f"GQA needs n_heads % n_kv_heads == 0 ({self.n_heads}/{self.n_kv_heads})"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def scaled_down(self, **overrides) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.family != "vlm" else 5),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=128,
            n_experts=min(self.n_experts, 4),
            mlstm_chunk=8,
            n_image_tokens=8 if self.n_image_tokens else 0,
            enc_layers=min(self.enc_layers, 2),
            dec_len=8 if self.enc_layers else self.dec_len,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            global_attn_layers=tuple(
                i for i in self.global_attn_layers
                if i < min(self.n_layers, 2)) or ((0,) if self.global_attn_layers else ()),
            cross_attn_every=self.cross_attn_every,
            dtype="float32",
        )
        small.update(overrides)
        return replace(self, **small)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head); used for
        MODEL_FLOPS = 6*N*D and checkpoint size estimates."""
        d, dh = self.d_model, self.head_dim
        h, hkv = self.n_heads, self.n_kv_heads
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d  # q, k+v, o
        if self.qkv_bias:
            attn += (h + 2 * hkv) * dh
        dense_ffn = 3 * d * self.d_ff                       # gate, up, down
        if self.is_moe:
            ffn = self.n_experts * dense_ffn + d * self.n_experts  # + router
        else:
            ffn = dense_ffn
        norms = 2 * d
        per_layer = attn + ffn + norms
        if self.family == "ssm_xlstm":
            d_in = self.ssm_expand * d
            mlstm = (3 * d * d_in + d_in * d + 2 * d_in)     # qkv+o+gates approx
            per_layer = mlstm + norms + dense_ffn if self.d_ff else mlstm + norms
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm = (2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state + 2)
                   + d_in * self.ssm_conv)
            per_layer = attn + ssm + dense_ffn + 3 * d
        layers = self.n_layers * per_layer
        if self.enc_layers:
            layers += self.enc_layers * (attn + dense_ffn + norms)
            layers += self.n_layers * (2 * d * hkv * dh + d * h * dh // max(h // h, 1))  # cross kv+q approx
        if self.cross_attn_every:
            n_cross = self.n_layers // (self.cross_attn_every)
            layers += n_cross * attn // 2
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return emb + layers + head

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        expert_ffn = 3 * self.d_model * self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * expert_ffn
        return full - self.n_layers * inactive


@dataclass(frozen=True)
class ShardingRecipe:
    """Named mesh axes of the tensor-parallel parameter specs and
    activation hooks (the reference's ``ShardingRecipe``;
    ``registry.make_param_specs`` and ``models/sharding.py`` read it).

    mode:
      'tp'       params replicated over data, sharded over model (ZeRO-1
                 handles the optimizer memory over data) — small/mid models.
      'tp_fsdp'  params additionally sharded over (pod, data) on a weight
                 axis — the >=90B models.
    """
    data_axes: tuple[str, ...] = ("data",)    # ('pod', 'data') multi-pod
    model_axis: str = "model"
    mode: str = "tp"
    # sequence-parallel attention (context parallelism) for long prefill:
    sequence_parallel: bool = False
    # model-axis size (0 = unknown); enables GQA head expansion when
    # kv-heads don't divide the axis (§Perf B: avoids GSPMD refactoring
    # between (hkv, g) and H shardings that forces full rematerialization)
    tp_size: int = 0
    expand_gqa: bool = False

    @property
    def batch_axes(self):
        return self.data_axes

    @property
    def fsdp_axes(self):
        return self.data_axes if self.mode == "tp_fsdp" else ()
