"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 => MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: inputs are
precomputed 4-codebook token streams (B, S, K=4); embeddings are summed and
K parallel LM heads predict each codebook (the delay-pattern scheduler is
outside the backbone).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, num_codebooks=4,
    act="gelu", tie_embeddings=False, remat="block",
    train_parallelism="dp",
)


def smoke():
    """A two-layer float32 config of the same family, for CPU tests."""
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128, num_codebooks=4,
        act="gelu", dtype="float32",
    )
