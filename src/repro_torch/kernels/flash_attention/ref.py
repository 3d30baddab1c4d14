"""Plain PyTorch version of the flash attention kernel (the JAX package's
``kernels/flash_attention/ref.py``): naive softmax attention in float32."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,H,S,dh); k: (B,KV,S,dh); v: (B,KV,S,dv) with H % KV == 0 ->
    (B,H,S,dv) in q's dtype. Query head h reads KV head h // (H/KV);
    scores (scaled by 1/√dh, q's head dim), softmax and the product with v
    run in float32."""
    b, h, s, dh = q.shape
    kv, dv = k.shape[1], v.shape[-1]
    g = h // kv
    qg = q.reshape(b, kv, g, s, dh).float()
    scores = torch.einsum("bkgqd,bkpd->bkgqp", qg, k.float()) / (dh ** 0.5)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqp,bkpd->bkgqd", p, v.float())
    return o.reshape(b, h, s, dv).to(q.dtype)
