"""qwen1.5-4b [dense] — QKV bias. 40L d=2560 20H (kv=20) d_ff=6912
vocab=151936 [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, qkv_bias=True, remat="block",
    # dp REFUTED for this arch: the 152k-vocab embedding/head gathers under
    # pure-DP cost 255 s of collectives vs 15.6 s TP (EXPERIMENTS §Perf it.4)
)


def smoke():
    """A two-layer float32 config of the same family (QKV bias), for
    CPU tests."""
    return ModelConfig(
        name="qwen-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, qkv_bias=True, dtype="float32",
    )
