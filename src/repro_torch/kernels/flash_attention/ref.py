"""Plain PyTorch version of the flash attention kernel (the JAX package's
``kernels/flash_attention/ref.py``): naive softmax attention in float32,
and its gradient (`attention_bwd_ref`, the plain version of the backward
kernel ``csrc/flash_attention_bwd.cu``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _probs(qg, k, causal):
    """Softmax of qg·kᵀ/√dh over the keys, float32: qg (B,KV,G,S,dh), k
    (B,KV,S,dh) -> (B,KV,G,S,S)."""
    s, dh = qg.shape[-2], qg.shape[-1]
    scores = torch.einsum("bkgqd,bkpd->bkgqp", qg, k.float()) / (dh ** 0.5)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=qg.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,H,S,dh); k: (B,KV,S,dh); v: (B,KV,S,dv) with H % KV == 0 ->
    (B,H,S,dv) in q's dtype. Query head h reads KV head h // (H/KV);
    scores (scaled by 1/√dh, q's head dim), softmax and the product with v
    run in float32."""
    b, h, s, dh = q.shape
    kv, dv = k.shape[1], v.shape[-1]
    qg = q.reshape(b, kv, h // kv, s, dh).float()
    p = _probs(qg, k, causal)
    o = torch.einsum("bkgqp,bkpd->bkgqd", p, v.float())
    return o.reshape(b, h, s, dv).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor,
                      causal: bool = True):
    """The gradient of `attention_ref`: (dq, dk, dv) in the dtypes of q, k
    and v, given its output o (B,H,S,dv) and dL/do. In float32, with
    P the softmax: dv = Pᵀ·dO and dk, dq from dS = P ∘ (dP − D), dP =
    dO·vᵀ, D = rowsum(dO ∘ o), each summed over a KV head's query heads."""
    b, h, s, dh = q.shape
    kv, dv = k.shape[1], v.shape[-1]
    g = h // kv
    qg = q.reshape(b, kv, g, s, dh).float()
    p = _probs(qg, k, causal)
    dog = do.reshape(b, kv, g, s, dv).float()
    delta = (dog * o.reshape(b, kv, g, s, dv).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bkpd->bkgqp", dog, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqp,bkpd->bkgqd", ds, k.float()) / (dh ** 0.5)
    dk = torch.einsum("bkgqp,bkgqd->bkpd", ds, qg) / (dh ** 0.5)
    dv_ = torch.einsum("bkgqp,bkgqd->bkpd", p, dog)
    return (dq.reshape(b, h, s, dh).to(q.dtype), dk.to(k.dtype),
            dv_.to(v.dtype))
