"""Model configuration: the port's copy of the JAX package's
`ModelConfig` and `PRESETS` (bigdl_tpu/models/config.py).

The dataclass keeps every field of its counterpart, so a configuration
built for one package builds the other field for field
(`ModelConfig(**dataclasses.asdict(cfg))`). The forward in
`models/llama.py` raises `NotImplementedError` for the flags this port
does not run yet. The HuggingFace `config.json` mapping waits for HF
ingest (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden // heads
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # qwen2-style qkv bias
    attention_out_bias: bool = False  # starcoder2: o_proj bias too
    mlp_bias: bool = False
    sliding_window: Optional[int] = None  # mistral-style local attention
    # gemma2/gemma3: layer l uses sliding attention iff (l+1) % pattern != 0
    # (None = every layer sliding when sliding_window is set, like mistral)
    sliding_window_pattern: Optional[int] = None
    # explicit per-layer sliding flags (gemma3 layer_types); overrides the
    # pattern when set
    sliding_layers: Optional[tuple] = None
    # gemma3: sliding layers rope with this base instead of rope_theta
    # (and without the global layers' rope_scaling)
    rope_local_theta: Optional[float] = None
    attn_logit_softcap: Optional[float] = None  # gemma2
    final_logit_softcap: Optional[float] = None  # gemma2
    # attention scale override (gemma2 query_pre_attn_scalar**-0.5); None =
    # 1/sqrt(head_dim)
    attn_scale: Optional[float] = None
    hidden_act: str = "silu"
    gated_mlp: bool = True  # False: plain fc->act->proj (starcoder2, gpt2)
    # normalization
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_bias: bool = False  # layernorm bias (starcoder2, stablelm)
    rms_norm_offset: bool = False  # gemma (1+w) rmsnorm weights
    post_attn_norm: bool = False  # gemma2 extra norms after attn/mlp blocks
    qk_norm: bool = False  # per-head RMSNorm on q/k (qwen3-style)
    # gemma-style embedding scale
    scale_embeddings: bool = False  # multiply embed output by sqrt(hidden)
    embedding_scale: Optional[float] = None  # minicpm scale_emb multiplier
    # minicpm residual scaling: hidden += scale_depth/sqrt(L) * block_out
    residual_scale: Optional[float] = None
    logit_scale: Optional[float] = None  # minicpm/cohere: logits *= scale
    lm_head_bias: bool = False  # phi-1/2: the lm head carries a bias
    # positions
    partial_rotary_factor: float = 1.0  # stablelm 0.25, glm 0.5
    rope_interleaved: bool = False  # GPT-NeoX/GLM pair-interleaved rope
    alibi: bool = False  # baichuan-13b/bloom attention-bias positions
    # multiplier on the alibi bias: falcon-rw folds the 1/sqrt(head_dim)
    # score scale into the bias too ((scores + alibi) * inv_norm_factor,
    # HF modeling_falcon eager path); bloom/baichuan/mpt add it unscaled
    alibi_scale: Optional[float] = None
    learned_positions: bool = False  # gpt2 wpe table (rope disabled)
    # qwen v1 logn attention: q *= max(1, log_train_len(pos+1)) for
    # positions beyond the training length (HF modeling_qwen logn_tensor)
    logn_attn: bool = False
    logn_train_len: int = 0
    parallel_residual: bool = False  # gptneox: h += attn(x) + mlp(x)
    embed_layernorm: bool = False  # bloom word_embeddings_layernorm
    # MoE (mixtral / qwen2_moe); 0 experts = dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    shared_expert_intermediate_size: Optional[int] = None  # qwen2_moe
    norm_topk_prob: bool = False  # renormalize top-k router weights
    # dispatch formulation: None = auto (dense for E<=8, ragged above),
    # or force "dense" / "ragged" (models/llama.py _moe_mlp)
    moe_dispatch: Optional[str] = None
    moe_capacity_factor: float = 1.25  # ragged: slots per expert vs even load
    # mllama (llama-3.2 vision): indices of the tanh-gated cross-attention
    # layers interleaved into the decoder (models/mllama.py)
    cross_attention_layers: Optional[tuple] = None
    # MLA (deepseek v2/v3, minicpm3 — models/deepseek.py): latent KV
    # compression ranks and split head dims; kv_lora_rank set = MLA
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    qk_rope_head_dim: Optional[int] = None
    v_head_dim: Optional[int] = None
    # DeepSeek-MoE routing (models/deepseek.py _router)
    n_group: Optional[int] = None
    topk_group: Optional[int] = None
    topk_method: Optional[str] = None  # greedy|group_limited_greedy|noaux_tc
    scoring_func: str = "softmax"  # v3: sigmoid
    routed_scaling_factor: float = 1.0
    first_k_dense_replace: int = 0
    n_shared_experts: Optional[int] = None  # ungated, n * moe_intermediate
    # RWKV (v4/v5): attention-free recurrence (models/rwkv.py). head_size
    # set = v5 multi-head matrix state; None = v4 scalar WKV
    attention_hidden_size: Optional[int] = None
    rwkv_head_size: Optional[int] = None
    rwkv_group_norm_eps: Optional[float] = None  # v5 ln_x GroupNorm eps
    # multimodal (qwen2_vl): M-RoPE channel sections for (t, h, w) position
    # components; standard rope when the three components are equal
    mrope_section: Optional[tuple] = None
    image_token_id: Optional[int] = None
    video_token_id: Optional[int] = None
    vision_start_token_id: Optional[int] = None
    audio_token_id: Optional[int] = None  # minicpmo audio placeholders
    audio_pool_step: Optional[int] = None  # minicpmo post-projection pool

    def __post_init__(self):
        if self.moe_dispatch not in (None, "dense", "ragged"):
            raise ValueError(
                f"moe_dispatch must be None, 'dense' or 'ragged'; "
                f"got {self.moe_dispatch!r}"
            )
        # ModelConfig is a static jit argument and must hash; rope_scaling
        # arrives as a dict from HF config.json (or a list-of-pairs after a
        # JSON round-trip through save_low_bit) — normalize to a tuple.
        rs = self.rope_scaling
        if isinstance(rs, dict):
            rs = tuple(sorted((k, _hashable(v)) for k, v in rs.items()))
        elif isinstance(rs, (list, tuple)):
            rs = tuple((k, _hashable(v)) for k, v in rs)
        object.__setattr__(self, "rope_scaling", rs)
        # list-typed fields arrive as lists after a JSON round-trip
        # (save_low_bit -> load_low_bit) and must re-become tuples or the
        # config stops hashing as a static jit argument
        for f in ("sliding_layers", "cross_attention_layers",
                  "mrope_section"):
            v = getattr(self, f)
            if isinstance(v, list):
                object.__setattr__(self, f, tuple(v))

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim_

    @property
    def rotary_dim(self) -> int:
        # keep even (rope rotates dim/2 pairs)
        r = int(self.head_dim_ * self.partial_rotary_factor)
        return r - (r % 2)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_is_sliding(self, layer_idx: int) -> bool:
        """Static per-layer attention kind (gemma2 alternation / gemma3
        explicit layer_types)."""
        if self.sliding_window is None:
            return False
        if self.sliding_layers is not None:
            return bool(self.sliding_layers[layer_idx])
        if self.sliding_window_pattern is None:
            return True
        return (layer_idx + 1) % self.sliding_window_pattern != 0


def _hashable(v):
    if isinstance(v, list):
        return tuple(v)
    return v


# Canonical shapes for tests and benchmarks (no checkpoints needed).
PRESETS: dict[str, ModelConfig] = {
    "tiny-llama": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128,
    ),
    "llama2-7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    ),
    "llama3-8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "mistral-7b": ModelConfig(
        model_type="mistral", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        sliding_window=4096, rope_theta=1000000.0,
    ),
    "qwen2-7b": ModelConfig(
        model_type="qwen2", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4,
        attention_bias=True, rope_theta=1000000.0,
    ),
    "gemma2-9b": ModelConfig(
        model_type="gemma2", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_hidden_layers=42,
        num_attention_heads=16, num_key_value_heads=8, head_dim=256,
        scale_embeddings=True, rms_norm_offset=True, post_attn_norm=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        sliding_window=4096, sliding_window_pattern=2,
        attn_scale=224.0 ** -0.5, tie_word_embeddings=True,
        hidden_act="gelu_pytorch_tanh",
    ),
    "phi3-mini": ModelConfig(
        model_type="phi3", vocab_size=32064, hidden_size=3072,
        intermediate_size=8192, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=4096,
    ),
    "mixtral-8x7b": ModelConfig(
        model_type="mixtral", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        rope_theta=1000000.0, num_experts=8, num_experts_per_tok=2,
        norm_topk_prob=True,
    ),
}
