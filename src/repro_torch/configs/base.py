"""Model/arch configuration system + the assigned input-shape suite (a copy
of the JAX package's ``configs/base.py``; `ModelConfig.param_count` counts
through the port's `repro_torch.models.model`).

Every ported architecture gets a frozen `ModelConfig` in its own module
(src/repro_torch/configs/<id>.py) with the exact published
hyperparameters, plus a `smoke()` reduced config of the same family for CPU
tests.

Input shapes (assigned suite — seq_len x global_batch):
    train_4k     4,096 x 256   -> train_step
    prefill_32k  32,768 x 32   -> serve_step (prefill scoring)
    decode_32k   32,768 x 128  -> serve_step (1 new token, KV cache = seq_len)
    long_500k    524,288 x 1   -> serve_step decode; sub-quadratic archs only
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's hyperparameters (field for field the JAX
    package's ModelConfig)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention variants ---
    qkv_bias: bool = False          # qwen1.5
    qk_norm: bool = False           # chameleon
    rope_theta: float = 10_000.0

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    dense_d_ff: int = 0             # hidden dim of dense (non-MoE) layers
    first_k_dense: int = 0          # deepseek-v2: leading dense layers
    moe_layer_step: int = 1         # llama4: MoE every k-th layer
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- SSM / linear attention ---
    block: str = "attn"             # attn | rwkv | mamba
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    shared_attn_every: int = 0      # zamba2: shared attn+MLP block period
    rwkv_lora_dim: int = 32

    # --- modality stubs ---
    num_codebooks: int = 1          # musicgen EnCodec codebooks

    # --- common ---
    act: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "none"             # none | block (activation checkpointing)
    unroll_layers: bool = False     # python-loop layers (dry-run cost probes)
    shard_activations: bool = False  # with_sharding_constraint on logits/CE
    train_parallelism: str = "tp"   # tp | dp — dp = pure ZeRO-3 over all
    # axes for training (small/attention-free archs: activation TP costs
    # ~30 full-activation collectives/layer; weight gathers are cheaper)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def attention_free(self) -> bool:
        """No attention block anywhere (pure RWKV or Mamba)."""
        return self.block in ("rwkv", "mamba") and self.shared_attn_every == 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear attention)."""
        return self.block in ("rwkv", "mamba")

    @property
    def d_inner(self) -> int:
        """Inner width of an SSM block."""
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Analytic parameter count a token uses (the routed experts at
        their experts per token)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the assigned suite."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k only runs for sub-quadratic archs (see DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch; long_500k requires "
                       "sub-quadratic sequence mixing")
    return True, ""
