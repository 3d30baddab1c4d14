"""chameleon-34b [vlm] — early-fusion over VQ image + text tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified]. Early fusion means image VQ codes live in
the shared vocab — the backbone consumes one token stream; the VQGAN
tokenizer is a stub (tokens precomputed). Chameleon's qk-norm is enabled
(its training-stability contribution).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, qk_norm=True,
    remat="block", train_parallelism="dp",
)


def smoke():
    """A two-layer float32 config of the same family (qk-norm), for
    CPU tests."""
    return ModelConfig(
        name="chameleon-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, qk_norm=True, dtype="float32",
    )
