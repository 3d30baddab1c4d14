"""Block composition and the prefill forward pass of the dense family (the
JAX package's ``models/transformer.py``).

A dense body is a Python loop over an `nn.ModuleList` of identical
(attention + MLP) blocks, where the reference scans over parameters stacked
on a leading L axis. The MoE, RWKV and Mamba bodies, decode and activation
checkpointing are not ported yet (ROADMAP §1).
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import attention, layers


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a family this slice does not run."""
    missing = [name for name, on in (
        ("MoE", cfg.moe), ("MLA", cfg.use_mla),
        (f"{cfg.block} blocks", cfg.block != "attn"),
        ("multi-codebook heads", cfg.num_codebooks > 1)) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention models only; "
            f"{', '.join(missing)} wait for later slices (ROADMAP §1)")


def init_attn_block(cfg, *, generator, device):
    """RMSNorms ln1/ln2, GQA attention and a gated MLP."""
    d_ff = cfg.dense_d_ff or cfg.d_ff
    return layers.params(
        ln1=layers.init_rmsnorm(cfg.d_model, device),
        ln2=layers.init_rmsnorm(cfg.d_model, device),
        attn=attention.init_gqa(cfg, generator=generator, device=device),
        mlp=layers.init_mlp(generator, cfg.d_model, d_ff,
                            layers.dtype_of(cfg), device))


def attn_block_prefill(p, cfg, x, positions):
    """Pre-norm residual block: x + attn(ln1 x), then + mlp(ln2 x)."""
    xn = layers.rms_norm(p.ln1, x, cfg.norm_eps)
    x = x + attention.gqa_prefill(p.attn, cfg, xn, positions)
    xn = layers.rms_norm(p.ln2, x, cfg.norm_eps)
    return x + layers.mlp(p.mlp, xn, cfg.act)


def init_body(cfg, *, generator, device):
    """cfg.num_layers blocks in an `nn.ModuleList` named ``blocks``."""
    check_supported(cfg)
    return layers.params(blocks=nn.ModuleList(
        init_attn_block(cfg, generator=generator, device=device)
        for _ in range(cfg.num_layers)))


def body_prefill(p, cfg, x, positions):
    """x: (B,S,d) -> (B,S,d) through every block in order."""
    for blk in p.blocks:
        x = attn_block_prefill(blk, cfg, x, positions)
    return x
