"""Plain PyTorch version of the linear scan kernel: the exact step-by-step
recurrence of the JAX package's ``models/scan_ops.py``
``linear_scan_recurrent``, on w clipped to [1e-6, 1] as its chunked path
(``linear_scan_chunked``) clips it.

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    o_t = q_t S_t                          (Mamba2: u is None)
    o_t = q_t (S_{t-1} + diag(u) k_tᵀ v_t)  (RWKV6: bonus u)

from a zero state. It forms no decay ratios, so it has no floor on the log
decay and no envelope: any w in (0, 1] is exact to rounding.
"""
from __future__ import annotations

import torch

W_MIN = 1e-6


def linear_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor | None = None, *,
                    compute_dtype: torch.dtype = torch.float32):
    """q, k, w: (B,H,S,dk); v: (B,H,S,dv); u: (H,dk) or None ->
    (o (B,H,S,dv) in v's dtype, final state (B,H,dk,dv) in
    `compute_dtype`). Every step runs in `compute_dtype` (float32, as the
    reference; float64 makes an arbiter for long sequences)."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    f = compute_dtype
    qf, kf, vf = q.to(f), k.to(f), v.to(f)
    wf = w.to(f).clamp(W_MIN, 1.0)
    uf = None if u is None else u.to(device=q.device, dtype=f)[None, :, :,
                                                               None]
    state = torch.zeros(b, h, dk, dv, dtype=f, device=q.device)
    out = torch.empty(b, h, s, dv, dtype=f, device=q.device)
    for t in range(s):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        if uf is None:
            state = state * wf[:, :, t, :, None] + kv
            read = state
        else:
            read = state + uf * kv
            state = state * wf[:, :, t, :, None] + kv
        out[:, :, t] = torch.einsum("bhk,bhkv->bhv", qf[:, :, t], read)
    return out.to(v.dtype), state
