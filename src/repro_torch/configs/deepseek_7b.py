"""deepseek-7b [dense] — llama-arch. 30L d=4096 32H (kv=32) d_ff=11008
vocab=102400 [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400, remat="block", train_parallelism="dp",
)


def smoke():
    """A two-layer float32 config of the same family (MHA), for CPU tests."""
    return ModelConfig(
        name="deepseek7b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128, dtype="float32",
    )
