"""GQA/MHA attention (+QKV bias, qk-norm) for prefill: the JAX package's
``models/attention.py`` ``init_gqa``, ``_gqa_qkv`` and ``gqa_prefill``.

Where the reference's prefill runs ``chunked_causal_attention`` (its jnp
analogue of the Pallas kernel), the port calls the hand-written
`flash_attention` kernel: exact causal attention, computed in one pass
without materializing S x S scores. Decode, MLA, context-parallel attention
and ``chunked_causal_attention`` are not ported yet (ROADMAP §1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers
from repro_torch.models.layers import dense_init, matmul


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
