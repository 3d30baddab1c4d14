"""smollm-360m [dense] — llama-arch small; the cheap-proxy tier of the SUPG
model zoo. 32L d=960 15H (kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, tie_embeddings=True, remat="block",
    train_parallelism="dp",
)


def smoke():
    """A two-layer float32 config of the same family, for CPU tests."""
    return ModelConfig(
        name="smollm-smoke", family="dense",
        num_layers=2, d_model=60, num_heads=3, num_kv_heads=1,
        d_ff=128, vocab_size=128, tie_embeddings=True, dtype="float32",
    )
