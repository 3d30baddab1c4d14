"""Block composition and the prefill and decode forward passes of the dense,
hybrid and RWKV6 families (the JAX package's ``models/transformer.py``).

A dense body is a Python loop over an `nn.ModuleList` of identical
(attention + MLP) blocks, where the reference scans over parameters stacked
on a leading L axis; an RWKV6 body the same over RWKV6 blocks. A hybrid
(Zamba2) body is a loop over super-blocks, each an `nn.ModuleList` of
Mamba2 blocks followed by the one shared attention + MLP block (one module,
run at every super-block), then a tail of Mamba2 blocks. Decode caches
follow the bodies: a list with one entry per block, and for the hybrid one
attention cache per invocation of the shared block (the reference stacks
them on the super-block axis). The MoE bodies, MLA and activation
checkpointing are not ported yet (ROADMAP §1).
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import attention, layers, mamba, rwkv


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a family this slice does not run."""
    missing = [name for name, on in (
        ("MoE", cfg.moe), ("MLA", cfg.use_mla),
        (f"{cfg.block} blocks", cfg.block not in ("attn", "mamba", "rwkv")),
        ("Mamba2 bodies without the shared block",
         cfg.block == "mamba" and not cfg.shared_attn_every),
        ("multi-codebook heads", cfg.num_codebooks > 1)) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention, hybrid Mamba2 and "
            f"RWKV6 models only; {', '.join(missing)} wait for later slices "
            f"(ROADMAP §1)")


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


def attn_block_decode(p, cfg, x, cache, pos):
    """One token through the block: x: (B,1,d), its KV cache written in
    place at pos -> (x, cache)."""
    xn = layers.rms_norm(p.ln1, x, cfg.norm_eps)
    h, cache = attention.gqa_decode(p.attn, cfg, xn, cache, pos)
    x = x + h
    xn = layers.rms_norm(p.ln2, x, cfg.norm_eps)
    return x + layers.mlp(p.mlp, xn, cfg.act), cache


def zamba_layout(cfg):
    """(super-blocks, Mamba2 blocks a super-block, tail blocks), as the
    reference stacks them."""
    every = cfg.shared_attn_every
    n_super = cfg.num_layers // every
    return n_super, every, cfg.num_layers - n_super * every


def _init_zamba_body(cfg, *, generator, device):
    n_super, per_super, tail = zamba_layout(cfg)

    def blocks(n):
        return nn.ModuleList(
            mamba.init_mamba_block(cfg, generator=generator, device=device)
            for _ in range(n))
    # drawn in the reference's order: super-blocks, tail, shared block
    members = {"mamba_super": nn.ModuleList(blocks(per_super)
                                            for _ in range(n_super))}
    if tail:
        members["mamba_tail"] = blocks(tail)
    members["shared_attn"] = init_attn_block(cfg, generator=generator,
                                             device=device)
    return layers.params(**members)


def init_body(cfg, *, generator, device):
    """Dense and RWKV6: cfg.num_layers blocks in an `nn.ModuleList` named
    ``blocks``. Hybrid: ``mamba_super`` (a list of lists of Mamba2 blocks),
    ``mamba_tail`` and the one ``shared_attn`` block."""
    check_supported(cfg)
    if cfg.block == "mamba":
        return _init_zamba_body(cfg, generator=generator, device=device)
    init_block = rwkv.init_rwkv_block if cfg.block == "rwkv" \
        else init_attn_block
    return layers.params(blocks=nn.ModuleList(
        init_block(cfg, generator=generator, device=device)
        for _ in range(cfg.num_layers)))


def _zamba_prefill(p, cfg, x, positions):
    for super_blks in p.mamba_super:
        for blk in super_blks:
            x, _ = mamba.mamba_block(blk, cfg, x)
        x = attn_block_prefill(p.shared_attn, cfg, x, positions)
    for blk in getattr(p, "mamba_tail", ()):
        x, _ = mamba.mamba_block(blk, cfg, x)
    return x


def body_prefill(p, cfg, x, positions):
    """x: (B,S,d) -> (B,S,d) through every block in order, from zero
    states."""
    if cfg.block == "mamba":
        return _zamba_prefill(p, cfg, x, positions)
    for blk in p.blocks:
        if cfg.block == "rwkv":
            x, _ = rwkv.rwkv_block(blk, cfg, x)
        else:
            x = attn_block_prefill(blk, cfg, x, positions)
    return x


def _zamba_decode(p, cfg, x, caches, pos):
    for super_blks, states, attn_cache in zip(
            p.mamba_super, caches["mamba_super"], caches["shared_attn"]):
        for blk, state in zip(super_blks, states):
            x, _ = mamba.mamba_block(blk, cfg, x, state)
        x, _ = attn_block_decode(p.shared_attn, cfg, x, attn_cache, pos)
    for blk, state in zip(getattr(p, "mamba_tail", ()),
                          caches.get("mamba_tail", ())):
        x, _ = mamba.mamba_block(blk, cfg, x, state)
    return x, caches


def body_decode(p, cfg, x, caches, pos):
    """x: (B,1,d) at per-row positions pos (B,) -> (x, caches), every cache
    and state of `caches` (as `model.init_caches` builds them) written in
    place."""
    if cfg.block == "mamba":
        return _zamba_decode(p, cfg, x, caches, pos)
    for blk, cache in zip(p.blocks, caches["blocks"]):
        if cfg.block == "rwkv":
            x, _ = rwkv.rwkv_block(blk, cfg, x, cache)
        else:
            x, _ = attn_block_decode(blk, cfg, x, cache, pos)
    return x, caches
