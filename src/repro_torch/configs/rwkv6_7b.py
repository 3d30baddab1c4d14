"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 [arXiv:2404.05892; hf].
head_size 64 => 64 wkv heads. Sub-quadratic: long_500k runs (O(1) state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=14336, vocab_size=65536,
    block="rwkv", ssm_head_dim=64, rwkv_lora_dim=64,
    remat="block", train_parallelism="dp",
)


def smoke():
    """A two-layer float32 config of the same family (four wkv heads of
    16), for CPU tests."""
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=128, vocab_size=128,
        block="rwkv", ssm_head_dim=16, rwkv_lora_dim=8, dtype="float32",
    )
