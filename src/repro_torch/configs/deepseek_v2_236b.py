"""deepseek-v2-236b [moe] — MLA + fine-grained MoE; the oracle-grade scorer.

60L d_model=5120 128H (MLA kv_lora=512, rope=64, nope=128, v=128,
q_lora=1536) moe_d_ff=1536, 2 shared + 160 routed top-6, first layer dense
(dense d_ff=12288), vocab=102400 [arXiv:2405.04434; hf].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536, vocab_size=102400,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    moe=True, num_experts=160, num_experts_per_tok=6,
    num_shared_experts=2, moe_d_ff=1536, dense_d_ff=12288, first_k_dense=1,
    remat="block",
)


def smoke():
    """A two-layer float32 config of the same family (a dense block, then
    an MLA + MoE block of 8 experts, top-2 softmax, one shared; MLA with a
    q rank of 32 and a latent of 16), for CPU tests."""
    return ModelConfig(
        name="dsv2-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=128,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe=True, num_experts=8, num_experts_per_tok=2,
        num_shared_experts=1, moe_d_ff=96, dense_d_ff=128, first_k_dense=1,
        dtype="float32",
    )
