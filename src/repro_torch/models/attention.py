"""GQA/MHA attention (+QKV bias, qk-norm) and MLA (DeepSeek-V2) for
prefill and decode: the JAX package's ``models/attention.py``
``init_gqa``, ``_gqa_qkv``, ``gqa_prefill``, ``decode_attention``,
``gqa_decode``, ``gqa_cache_spec``, ``init_mla``, ``_mla_q``,
``_mla_latent``, ``mla_prefill``, ``mla_decode``, ``mla_cache_spec``,
``context_parallel_attention`` and ``_attention_dispatch``.

Where the reference's prefill runs ``chunked_causal_attention`` (its jnp
analogue of the Pallas kernel), the port calls the hand-written
`flash_attention` kernel: exact causal attention, computed in one pass
without materializing S x S scores. Decode attends one query a row against
a KV cache with per-row lengths; the reference computes it with jnp outside
any kernel, so the port's is plain PyTorch with the same float32 scores
and softmax. What differs: the cache is written in place at each row's
position (the reference returns a new cache, which XLA writes in place
under donation), and the float32 products run over blocks of cache
positions, so a step never holds a float32 copy of a whole cache.

MLA's prefill materializes per-head k = [k_nope | k_rope broadcast to
every head] (q·k over dn + dr = 192 dims at deepseek-v2's widths) and v
(dv = 128), as the reference does, and runs them through the same
`flash_attention` kernel at (dh, dv) = (192, 128). Its decode is the
reference's absorbed form in plain PyTorch: scores and outputs in the
latent space of the (B, S, r_kv) cache, which holds r_kv + dr numbers a
token whatever the number of heads. ``chunked_causal_attention`` has no
port, since the prefills call the kernel where the reference calls it.

Context parallelism (`context_parallel_attention`): under a mesh with
``cfg.shard_activations`` and a "model" axis of m > 1 ranks, where m·128
divides S, the prefills split the query rows over the model group as the
reference shards its query chunks: rank r owns rows [r·S/m, (r+1)·S/m)
and attends them against every key up to its last row, in one launch of
the kernel with keys longer than queries; an all-gather over the group in
rank order rebuilds (B, S, H, dv). On the card each row then reads the
same key tiles in the same order as in one launch over all S rows, so the
output is that launch's, bit for bit. It is head-count agnostic: the
reason the reference has it (smollm-360m's 15 heads do not divide a
model axis of 16). The wo projection after attention is
`layers.matmul_rowparallel`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention.ops import TILE_Q, flash_attention
from repro_torch.models import layers, meshctx
from repro_torch.models.layers import dense_init, matmul, matmul_rowparallel

NEG_INF = -1e30
# float32 elements of K or V that decode attention casts at a time (a block
# of cache positions): 256 MiB
DECODE_BLOCK_ELEMS = 1 << 26


def init_gqa(cfg, *, generator, device):
    """Projections wq (d, H·hd), wk and wv (d, KV·hd), wo (H·hd, d); zero
    biases if cfg.qkv_bias; per-head RMSNorms if cfg.qk_norm."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = layers.dtype_of(cfg)
    p = {
        "wq": dense_init(generator, d, h * hd, dt, device),
        "wk": dense_init(generator, d, kvh * hd, dt, device),
        "wv": dense_init(generator, d, kvh * hd, dt, device),
        "wo": dense_init(generator, h * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=dt, device=device)
        p["bk"] = torch.zeros(kvh * hd, dtype=dt, device=device)
        p["bv"] = torch.zeros(kvh * hd, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(hd, device)
        p["k_norm"] = layers.init_rmsnorm(hd, device)
    return layers.params(**p)


def _gqa_qkv(p, cfg, x, positions):
    """x: (B,S,d) -> q (B,S,H,hd), k and v (B,S,KV,hd), rotated."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = matmul(x, p.wq)
    k = matmul(x, p.wk)
    v = matmul(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(p.q_norm, q, cfg.norm_eps)
        k = layers.rms_norm(p.k_norm, k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def context_parallel_attention(q, k, v, *, m_size):
    """Causal attention with the query rows split over the "model" axis of
    the current mesh, m_size ranks: q (B,S,H,dh), k
    (B,S,KV,dh) and v (B,S,KV,dv), whole on every rank of the group ->
    (B,S,H,dv), whole on every rank. Rank r launches the kernel once on
    query rows [r·S/m, (r+1)·S/m) against keys [0, (r+1)·S/m); one
    all-gather over the group, in rank order, rebuilds the rows."""
    group, r, m = meshctx.model_group(meshctx.current_mesh())
    b, s = q.shape[:2]
    if m != m_size or s % m:
        raise ValueError(f"{s} query rows over a model group of {m} ranks "
                         f"(m_size {m_size})")
    rows = s // m
    lo, hi = r * rows, (r + 1) * rows
    o = flash_attention(q[:, lo:hi].contiguous(), k[:, :hi].contiguous(),
                        v[:, :hi].contiguous(), causal=True)
    parts = [torch.empty_like(o) for _ in range(m)]
    dist.all_gather(parts, o, group=group)
    return torch.cat(parts, dim=1)


def _attention_dispatch(cfg, q, k, v):
    """Context-parallel attention where ``cfg.shard_activations``, the
    current mesh has a "model" axis of m > 1 ranks and m·128 divides S
    (the reference's condition); else one causal launch over all rows."""
    if cfg.shard_activations:
        m = meshctx.model_size(meshctx.current_mesh())
        if m > 1 and q.shape[1] % (m * TILE_Q) == 0:
            return context_parallel_attention(q, k, v, m_size=m)
    return flash_attention(q, k, v, causal=True)


def gqa_prefill(p, cfg, x, positions):
    """Causal GQA self-attention over the whole sequence: (B,S,d) ->
    (B,S,d)."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    o = _attention_dispatch(cfg, q, k, v)
    return matmul_rowparallel(o.reshape(b, s, -1), p.wo, cfg)


def decode_attention(q, cache_k, cache_v, pos):
    """q: (B,1,H,dh); cache_k, cache_v: (B,S,KV,dh); pos: (B,) -> (B,1,H,dh)
    in q's dtype: softmax attention over the cache positions <= pos, with
    float32 scores and softmax, as the reference's; positions past a row's
    pos score NEG_INF (a row with pos < 0 attends evenly to all)."""
    b, _, h, dh = q.shape
    s, kv = cache_k.shape[1], cache_k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, dh).float()
    scale = float(np.float32(1) / np.sqrt(np.float32(dh)))
    block = max(1, DECODE_BLOCK_ELEMS // (b * kv * dh))

    def cast(cache, lo):
        # (B,KV,n,dh) float32, one pass over the block
        return cache[:, lo:lo + block].transpose(1, 2).to(
            torch.float32, memory_format=torch.contiguous_format)
    scores = torch.cat([torch.matmul(qg, cast(cache_k, lo).transpose(-1, -2))
                        for lo in range(0, s, block)], dim=-1) * scale
    valid = torch.arange(s, device=q.device)[None] <= pos[:, None]  # (B,S)
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = sum(torch.matmul(p[..., lo:lo + block], cast(cache_v, lo))
              for lo in range(0, s, block))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _write_at(cache, new, pos):
    """cache[b, at_b] = new[b, 0] in place for each row b, placed as the
    reference's ``dynamic_update_slice`` places its start: a negative pos
    counts from the end (pos + S), then the start is clamped into
    [0, S-1]."""
    s = cache.shape[1]
    at = torch.where(pos < 0, pos + s, pos).clamp(0, s - 1)
    cache[torch.arange(len(pos), device=pos.device), at] = \
        new[:, 0].to(cache.dtype)


def gqa_decode(p, cfg, x, cache, pos):
    """x: (B,1,d); cache: {'k','v'}: (B,S,KV,hd); pos: (B,) -> ((B,1,d),
    cache). q, k and v are rotated at each row's own position; k and v are
    written into the cache in place at pos (`_write_at`). Then the query
    attends over positions <= pos."""
    b = x.shape[0]
    q, k_new, v_new = _gqa_qkv(p, cfg, x, pos[:, None])
    _write_at(cache["k"], k_new, pos)
    _write_at(cache["v"], v_new, pos)
    o = decode_attention(q, cache["k"], cache["v"], pos)
    return matmul(o.reshape(b, 1, -1), p.wo), cache


def gqa_cache_spec(cfg, batch, seq_len, dtype):
    """{'k', 'v'}: ((B, S, KV, hd), dtype) each."""
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


# --------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2)
# --------------------------------------------------------------------------

def init_mla(cfg, *, generator, device):
    """The latent projection w_dkv (d, r_kv + dr) and its RMSNorm kv_norm,
    the up-projections w_uk (r_kv, H·dn) and w_uv (r_kv, H·dv), wo (H·dv,
    d); the query through w_dq (d, r_q), q_norm and w_uq (r_q, H·(dn+dr))
    if cfg.q_lora_rank, else wq (d, H·(dn+dr)). Drawn in the reference's
    key order."""
    d, h = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = layers.dtype_of(cfg)
    p = {}
    if r_q:
        p["w_dq"] = dense_init(generator, d, r_q, dt, device)
        p["q_norm"] = layers.init_rmsnorm(r_q, device)
        p["w_uq"] = dense_init(generator, r_q, h * (dn + dr), dt, device)
    else:
        p["wq"] = dense_init(generator, d, h * (dn + dr), dt, device)
    p["w_dkv"] = dense_init(generator, d, r_kv + dr, dt, device)
    p["kv_norm"] = layers.init_rmsnorm(r_kv, device)
    p["w_uk"] = dense_init(generator, r_kv, h * dn, dt, device)
    p["w_uv"] = dense_init(generator, r_kv, h * dv, dt, device)
    p["wo"] = dense_init(generator, h * dv, d, dt, device)
    return layers.params(**p)


def _mla_q(p, cfg, x, positions):
    """x: (B,S,d) -> q_nope (B,S,H,dn) and q_rope (B,S,H,dr), rotated."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q = matmul(layers.rms_norm(p.q_norm, matmul(x, p.w_dq),
                                   cfg.norm_eps), p.w_uq)
    else:
        q = matmul(x, p.wq)
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, cfg, x, positions):
    """x: (B,S,d) -> the normed latent c (B,S,r_kv) and the one rotary key
    k_rope (B,S,dr) all heads share."""
    dkv = matmul(x, p.w_dkv)
    c = layers.rms_norm(p.kv_norm, dkv[..., :cfg.kv_lora_rank],
                        cfg.norm_eps)
    k_rope = dkv[..., cfg.kv_lora_rank:][..., None, :]
    k_rope = layers.apply_rope(k_rope, positions, cfg.rope_theta)[..., 0, :]
    return c, k_rope


def mla_prefill(p, cfg, x, positions):
    """Causal MLA self-attention over the whole sequence, k and v
    materialized per head: (B,S,d) -> (B,S,d). The kernel scales q·k by
    1/√(dn + dr), as the reference's attention scales by q's head dim."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = matmul(c, p.w_uk).reshape(b, s, h, dn)
    v = matmul(c, p.w_uv).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    o = _attention_dispatch(cfg, q, k, v)
    return matmul_rowparallel(o.reshape(b, s, -1), p.wo, cfg)


def mla_decode(p, cfg, x, cache, pos):
    """Absorbed-latent decode. x: (B,1,d); cache: {'c': (B,S,r_kv),
    'k_rope': (B,S,dr)}; pos: (B,) -> ((B,1,d), cache).

    The new token's c and k_rope are written into the cache in place at
    pos (`_write_at`). A position's score is
    (q_nope·W_uk)·c_s + q_rope·k_rope_s over 1/√(dn + dr), without per-head
    K or V; scores, softmax and o_lat = p·c run in float32 over blocks of
    cache positions (a float32 copy of one block of c at a time, as
    `decode_attention` casts), then o = o_lat·W_uv and wo. The reference's
    bf16 einsums accumulate in float32 (``preferred_element_type``); here
    their operands are cast to float32, the same products."""
    b, s = x.shape[0], cache["c"].shape[1]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None])        # (B,1,H,*)
    c_new, kr_new = _mla_latent(p, cfg, x, pos[:, None])
    _write_at(cache["c"], c_new, pos)
    _write_at(cache["k_rope"], kr_new, pos)

    w_uk = p.w_uk.reshape(r_kv, h, dn).float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
    q_rope = q_rope[:, 0].float()                           # (B,H,dr)
    block = max(1, DECODE_BLOCK_ELEMS // (b * (r_kv + dr)))

    def cast(t, lo):
        # (B,n,r) float32 of one block of positions
        return t[:, lo:lo + block].float()
    scores = torch.cat([
        torch.matmul(q_lat, cast(cache["c"], lo).transpose(1, 2))
        + torch.matmul(q_rope, cast(cache["k_rope"], lo).transpose(1, 2))
        for lo in range(0, s, block)], dim=-1)              # (B,H,S)
    scale = float(np.float32(1) / np.sqrt(np.float32(dn + dr)))
    valid = torch.arange(s, device=x.device)[None] <= pos[:, None]
    scores = (scores * scale).masked_fill(~valid[:, None], NEG_INF)
    pattn = torch.softmax(scores, dim=-1)
    o_lat = sum(torch.matmul(pattn[..., lo:lo + block], cast(cache["c"], lo))
                for lo in range(0, s, block))               # (B,H,r_kv)
    w_uv = p.w_uv.reshape(r_kv, h, dv).float()
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
    y = matmul(o.reshape(b, 1, -1).to(x.dtype), p.wo)
    return y, cache


def mla_cache_spec(cfg, batch, seq_len, dtype):
    """{'c': ((B, S, r_kv), dtype), 'k_rope': ((B, S, dr), dtype)}."""
    return {"c": ((batch, seq_len, cfg.kv_lora_rank), dtype),
            "k_rope": ((batch, seq_len, cfg.qk_rope_head_dim), dtype)}
