"""llama4-maverick-400b-a17b [moe] — interleaved MoE (every 2nd layer),
top-1 routing + shared expert, early fusion (patch embeds stubbed: token
stream precomputed). 48L d=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
128 routed experts [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
Sigmoid router gate (llama4 uses per-expert sigmoid, not softmax).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe=True, num_experts=128, num_experts_per_tok=1,
    num_shared_experts=1, moe_d_ff=8192, dense_d_ff=8192, moe_layer_step=2,
    rope_theta=500_000.0, remat="block",
)


def smoke():
    """A two-layer float32 config of the same family (one pair: a dense
    block, then an MoE block of 4 experts, top-1 sigmoid, one shared),
    for CPU tests."""
    return ModelConfig(
        name="llama4-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128,
        moe=True, num_experts=4, num_experts_per_tok=1,
        num_shared_experts=1, moe_d_ff=128, dense_d_ff=128, moe_layer_step=2,
        dtype="float32",
    )
