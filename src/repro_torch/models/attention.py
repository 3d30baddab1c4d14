"""GQA/MHA attention (+QKV bias, qk-norm) for prefill and decode: the JAX
package's ``models/attention.py`` ``init_gqa``, ``_gqa_qkv``,
``gqa_prefill``, ``decode_attention``, ``gqa_decode`` and
``gqa_cache_spec``.

Where the reference's prefill runs ``chunked_causal_attention`` (its jnp
analogue of the Pallas kernel), the port calls the hand-written
`flash_attention` kernel: exact causal attention, computed in one pass
without materializing S x S scores. Decode attends one query a row against
a KV cache with per-row lengths; the reference computes it with jnp outside
any kernel, so the port's is plain PyTorch with the same float32 scores
and softmax. What differs: the cache is written in place at each row's
position (the reference returns a new cache, which XLA writes in place
under donation), and the float32 products run over blocks of cache
positions, so a step never holds a float32 copy of a whole cache. MLA,
context-parallel attention and ``chunked_causal_attention`` are not ported
yet (ROADMAP §1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers
from repro_torch.models.layers import dense_init, matmul

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


def gqa_prefill(p, cfg, x, positions):
    """Causal GQA self-attention over the whole sequence: (B,S,d) ->
    (B,S,d)."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    o = flash_attention(q, k, v, causal=True)
    return matmul(o.reshape(b, s, -1), p.wo)


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


def gqa_decode(p, cfg, x, cache, pos):
    """x: (B,1,d); cache: {'k','v'}: (B,S,KV,hd); pos: (B,) -> ((B,1,d),
    cache). q, k and v are rotated at each row's own position; k and v are
    written into the cache in place at pos as the reference's
    ``dynamic_update_slice`` places its start: a negative pos counts from
    the end (pos + S), then the start is clamped into [0, S-1]. Then the
    query attends over positions <= pos."""
    b, s = x.shape[0], cache["k"].shape[1]
    q, k_new, v_new = _gqa_qkv(p, cfg, x, pos[:, None])
    rows = torch.arange(b, device=x.device)
    at = torch.where(pos < 0, pos + s, pos).clamp(0, s - 1)
    cache["k"][rows, at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, at] = v_new[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], pos)
    return matmul(o.reshape(b, 1, -1), p.wo), cache


def gqa_cache_spec(cfg, batch, seq_len, dtype):
    """{'k', 'v'}: ((B, S, KV, hd), dtype) each."""
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}
