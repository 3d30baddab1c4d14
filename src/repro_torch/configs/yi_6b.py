"""yi-6b [dense] — llama-arch GQA. 32L d=4096 32H (kv=4) d_ff=11008
vocab=64000 [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, remat="block", train_parallelism="dp",
)


def smoke():
    """A two-layer float32 config of the same family (GQA 4/2), for CPU
    tests."""
    return ModelConfig(
        name="yi-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, dtype="float32",
    )
