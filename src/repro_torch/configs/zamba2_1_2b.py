"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

38L d_model=2048, ssm_state=64, shared attn 32H (kv=32, hd=64) + MLP
d_ff=8192, reused every 6 Mamba2 layers [arXiv:2411.15242; hf].
Sub-quadratic backbone: long_500k runs (decode attention is O(S) per token,
Mamba state is O(1)).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    block="mamba", ssm_state_dim=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, remat="block",
)


def smoke():
    """A five-layer float32 config of the same family (two super-blocks of
    two Mamba2 blocks and the shared block, then one tail block), for CPU
    tests."""
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128,
        block="mamba", ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2,
        shared_attn_every=2, dtype="float32",
    )
