"""Block composition and the prefill and decode forward passes of the dense,
MoE (with GQA or MLA attention), hybrid and RWKV6 families (the JAX
package's ``models/transformer.py``).

A dense body is a Python loop over an `nn.ModuleList` of identical
(attention + MLP) blocks, where the reference scans over parameters stacked
on a leading L axis; an RWKV6 body the same over RWKV6 blocks. An MoE body
with ``moe_layer_step > 1`` (llama4) loops over pairs, ``pairs_dense[i]``
(attention + MLP) then ``pairs_moe[i]`` (attention + MoE); one with
``moe_layer_step == 1`` (deepseek-v2's layout) runs ``dense_prefix`` then
``moe_blocks``. A block's attention is MLA where ``cfg.use_mla``, GQA
otherwise. A hybrid (Zamba2) body is a loop over super-blocks, each an
`nn.ModuleList` of Mamba2 blocks followed by the one shared attention + MLP
block (one module, run at every super-block), then a tail of Mamba2 blocks.
Decode caches follow the bodies: a list with one entry per block, and for
the hybrid one attention cache per invocation of the shared block (the
reference stacks them on the super-block axis). Activation checkpointing
(``cfg.remat == "block"``, `_maybe_remat`) recomputes each block's
internals in the backward, as the reference's ``jax.checkpoint`` of each
scanned body does: a dense, MoE or RWKV6 block, a hybrid's super-block.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention, layers, mamba, moe, rwkv


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a family this slice does not run."""
    missing = [name for name, on in (
        (f"{cfg.block} blocks", cfg.block not in ("attn", "mamba", "rwkv")),
        ("Mamba2 bodies without the shared block",
         cfg.block == "mamba" and not cfg.shared_attn_every)) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention (one or several "
            f"codebooks), MoE (GQA or MLA), hybrid Mamba2 and RWKV6 models "
            f"only; {', '.join(missing)} wait for later slices (ROADMAP §1)")


def _maybe_remat(fn, cfg):
    """`fn` under activation checkpointing where ``cfg.remat == "block"``
    and autograd records: its outputs are kept, its internals recomputed
    in the backward (launching the forward kernels again)."""
    if cfg.remat != "block":
        return fn

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return remat


def gate_fn_of(cfg) -> str:
    """The router's gate: sigmoid for an interleaved MoE (llama4), softmax
    otherwise, as the reference chooses it."""
    return "sigmoid" if cfg.moe_layer_step > 1 else "softmax"


def init_attn_block(cfg, *, generator, device, ffn="mlp"):
    """RMSNorms ln1/ln2, MLA (cfg.use_mla) or GQA attention, and a gated
    MLP (``ffn="mlp"``) or an MoE layer (``ffn="moe"``)."""
    init_attn = attention.init_mla if cfg.use_mla else attention.init_gqa
    members = dict(
        ln1=layers.init_rmsnorm(cfg.d_model, device),
        ln2=layers.init_rmsnorm(cfg.d_model, device),
        attn=init_attn(cfg, generator=generator, device=device))
    if ffn == "mlp":
        members["mlp"] = layers.init_mlp(generator, cfg.d_model,
                                         cfg.dense_d_ff or cfg.d_ff,
                                         layers.dtype_of(cfg), device)
    else:
        members["moe"] = moe.init_moe(cfg, generator=generator,
                                      device=device)
    return layers.params(**members)


def _ffn(p, cfg, xn, ffn):
    """The block's feed-forward half: (output, the MoE's aux loss or None
    for an MLP)."""
    if ffn == "mlp":
        return layers.mlp(p.mlp, xn, cfg.act, cfg), None
    return moe.moe_apply(p.moe, cfg, xn, gate_fn_of(cfg))


def _zero_aux(x):
    """A float32 zero aux loss on x's device."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def attn_block_prefill(p, cfg, x, positions, ffn="mlp"):
    """Pre-norm residual block: x + attn(ln1 x), then + mlp(ln2 x) or
    + moe(ln2 x) -> (x, aux loss), the aux 0 for an MLP block."""
    xn = layers.rms_norm(p.ln1, x, cfg.norm_eps)
    attn_fn = attention.mla_prefill if cfg.use_mla else attention.gqa_prefill
    x = x + attn_fn(p.attn, cfg, xn, positions)
    xn = layers.rms_norm(p.ln2, x, cfg.norm_eps)
    h, aux = _ffn(p, cfg, xn, ffn)
    return x + h, _zero_aux(x) if aux is None else aux


def attn_block_decode(p, cfg, x, cache, pos, ffn="mlp"):
    """One token through the block: x: (B,1,d), its KV (or MLA latent)
    cache written in place at pos -> (x, cache). An MoE block routes the
    step's B tokens, its capacity taken from n = B as in the reference."""
    xn = layers.rms_norm(p.ln1, x, cfg.norm_eps)
    attn_fn = attention.mla_decode if cfg.use_mla else attention.gqa_decode
    h, cache = attn_fn(p.attn, cfg, xn, cache, pos)
    x = x + h
    xn = layers.rms_norm(p.ln2, x, cfg.norm_eps)
    return x + _ffn(p, cfg, xn, ffn)[0], cache


def moe_layout(cfg):
    """An MoE body's two block lists, each as (parameter name, cache name,
    feed-forward, blocks): interleaved (``moe_layer_step > 1``),
    ``pairs_dense``/``dense`` and ``pairs_moe``/``moe``, each of
    num_layers // moe_layer_step blocks and run pair by pair; otherwise
    ``dense_prefix`` of max(first_k_dense, 1) blocks, then ``moe_blocks``
    of num_layers - first_k_dense. Where first_k_dense is 0 the reference
    builds and runs one dense block all the same: L + 1 blocks."""
    if cfg.moe_layer_step > 1:
        n = cfg.num_layers // cfg.moe_layer_step
        return (("pairs_dense", "dense", "mlp", n),
                ("pairs_moe", "moe", "moe", n))
    return (("dense_prefix", "dense_prefix", "mlp",
             max(cfg.first_k_dense, 1)),
            ("moe_blocks", "moe_blocks", "moe",
             cfg.num_layers - cfg.first_k_dense))


def _moe_order(cfg):
    """(parameter name, cache name, feed-forward, index) of every block of
    an MoE body, in the order a token runs them."""
    first, second = moe_layout(cfg)
    if cfg.moe_layer_step > 1:
        return [(*part[:3], i) for i in range(first[3])
                for part in (first, second)]
    return [(*part[:3], i) for part in (first, second)
            for i in range(part[3])]


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
    ``blocks``. MoE: the two `nn.ModuleList`s of `moe_layout`. Hybrid:
    ``mamba_super`` (a list of lists of Mamba2 blocks), ``mamba_tail`` and
    the one ``shared_attn`` block."""
    check_supported(cfg)
    if cfg.block == "mamba":
        return _init_zamba_body(cfg, generator=generator, device=device)
    if cfg.moe:
        return layers.params(**{
            name: nn.ModuleList(
                init_attn_block(cfg, generator=generator, device=device,
                                ffn=ffn) for _ in range(n))
            for name, _, ffn, n in moe_layout(cfg)})
    init_block = rwkv.init_rwkv_block if cfg.block == "rwkv" \
        else init_attn_block
    return layers.params(blocks=nn.ModuleList(
        init_block(cfg, generator=generator, device=device)
        for _ in range(cfg.num_layers)))


def _zamba_prefill(p, cfg, x, positions):
    def super_block(super_blks, x):
        for blk in super_blks:
            x, _ = mamba.mamba_block(blk, cfg, x)
        return attn_block_prefill(p.shared_attn, cfg, x, positions)[0]

    def tail_block(blk, x):
        return mamba.mamba_block(blk, cfg, x)[0]
    super_block, tail_block = (_maybe_remat(f, cfg)
                               for f in (super_block, tail_block))
    for super_blks in p.mamba_super:
        x = super_block(super_blks, x)
    for blk in getattr(p, "mamba_tail", ()):
        x = tail_block(blk, x)
    return x


def body_prefill(p, cfg, x, positions):
    """x: (B,S,d) -> ((B,S,d), aux loss) through every block in order,
    from zero states; the aux loss (float32) sums the MoE blocks' and is 0
    for the other families."""
    aux = _zero_aux(x)
    if cfg.block == "mamba":
        return _zamba_prefill(p, cfg, x, positions), aux
    attn_block = _maybe_remat(
        lambda blk, x, ffn="mlp": attn_block_prefill(blk, cfg, x, positions,
                                                     ffn), cfg)
    if cfg.moe:
        for name, _, ffn, i in _moe_order(cfg):
            x, a = attn_block(getattr(p, name)[i], x, ffn)
            aux = aux + a
        return x, aux
    rwkv_block = _maybe_remat(
        lambda blk, x: rwkv.rwkv_block(blk, cfg, x)[0], cfg)
    for blk in p.blocks:
        if cfg.block == "rwkv":
            x = rwkv_block(blk, x)
        else:
            x, _ = attn_block(blk, x)
    return x, aux


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
    if cfg.moe:
        for name, cache_name, ffn, i in _moe_order(cfg):
            x, _ = attn_block_decode(getattr(p, name)[i], cfg, x,
                                     caches[cache_name][i], pos, ffn)
        return x, caches
    for blk, cache in zip(p.blocks, caches["blocks"]):
        if cfg.block == "rwkv":
            x, _ = rwkv.rwkv_block(blk, cfg, x, cache)
        else:
            x, _ = attn_block_decode(blk, cfg, x, cache, pos)
    return x, caches
