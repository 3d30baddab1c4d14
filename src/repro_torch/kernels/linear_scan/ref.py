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


def _clip_mask(w: torch.Tensor) -> torch.Tensor:
    """The reference's ``jnp.clip(w, 1e-6, 1)`` gradient factor, in w's own
    dtype: 1 strictly inside, 0.5 where w equals either end (JAX splits a
    tie of ``maximum``/``minimum`` in half), 0 outside."""
    inside = (w > W_MIN) & (w < 1.0)
    tie = (w == W_MIN) | (w == 1.0)
    return torch.where(inside, 1.0, torch.where(tie, 0.5, 0.0))


def linear_scan_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor | None,
                        do: torch.Tensor, *,
                        compute_dtype: torch.dtype = torch.float32,
                        chunk: int = 64):
    """The gradient of `linear_scan_ref`'s o, given dL/do (B,H,S,dv), with
    no gradient into the final state: (dq, dk, dv, dw, du), each in its
    input's dtype (du None where u is).

    The exact reverse-time recurrence, not the autograd of the step loop.
    With dS_t = dL/dS_t:

    * Mamba2 (read after the update): dS_t = q_tᵀ do_t + diag(w_{t+1})
      dS_{t+1}; dq_t = do_t S_tᵀ.
    * RWKV6 (read before the update, bonus u): dS_{t-1} = q_tᵀ do_t +
      diag(w_t) dS_t; dq_t = do_t S_{t-1}ᵀ + u ⊙ k_t (do_t · v_t); the bonus
      adds u ⊙ q_t (do_t · v_t) to dk_t, c_t do_t to dv_t (c_t = q_t · u ·
      k_t) and q_t ⊙ k_t (do_t · v_t) to du.
    * Both: dk_t = dS_t v_tᵀ, dv_t = k_t dS_t, dw_t[i] = Σ_j dS_t[i, j]
      S_{t-1}[i, j], times the reference's clip factor (`_clip_mask`).

    The forward keeps the state before every `chunk` steps; the reverse
    sweep rebuilds a chunk's states from it by the forward recurrence, so
    nothing divides by w. Every step runs in `compute_dtype` (float32, as
    the reference; float64 makes an arbiter)."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    f = compute_dtype
    qf, kf, vf, dof = (t.to(f) for t in (q, k, v, do))
    wf = w.to(f).clamp(W_MIN, 1.0)
    uf = None if u is None else u.to(device=q.device, dtype=f)[None]

    def step(state, t):
        return (state * wf[:, :, t, :, None]
                + kf[:, :, t, :, None] * vf[:, :, t, None, :])

    starts = list(range(0, s, chunk))
    kept = []
    state = torch.zeros(b, h, dk, dv, dtype=f, device=q.device)
    for c0 in starts:
        kept.append(state)
        for t in range(c0, min(c0 + chunk, s)):
            state = step(state, t)
    gq, gk, gw = (torch.empty(b, h, s, dk, dtype=f, device=q.device)
                  for _ in range(3))
    gv = torch.empty(b, h, s, dv, dtype=f, device=q.device)
    gu = None if u is None else torch.zeros(h, dk, dtype=f, device=q.device)
    ds = torch.zeros(b, h, dk, dv, dtype=f, device=q.device)
    for c0, first in zip(reversed(starts), reversed(kept)):
        states = [first]                    # states[i] = S_{c0 + i - 1}
        for t in range(c0, min(c0 + chunk, s)):
            states.append(step(states[-1], t))
        for t in reversed(range(c0, min(c0 + chunk, s))):
            prev, cur = states[t - c0], states[t - c0 + 1]
            qt, kt, vt, dot = qf[:, :, t], kf[:, :, t], vf[:, :, t], \
                dof[:, :, t]
            outer = qt[..., :, None] * dot[..., None, :]
            if uf is None:
                ds = ds + outer
                gq[:, :, t] = torch.einsum("bhkv,bhv->bhk", cur, dot)
            else:
                dov = (dot * vt).sum(-1, keepdim=True)          # (b,h,1)
                gq[:, :, t] = (torch.einsum("bhkv,bhv->bhk", prev, dot)
                               + uf * kt * dov)
            gk[:, :, t] = torch.einsum("bhkv,bhv->bhk", ds, vt)
            gv[:, :, t] = torch.einsum("bhkv,bhk->bhv", ds, kt)
            gw[:, :, t] = (ds * prev).sum(-1)
            if uf is None:
                ds = ds * wf[:, :, t, :, None]
            else:
                gk[:, :, t] += uf * qt * dov
                gv[:, :, t] += (qt * uf * kt).sum(-1, keepdim=True) * dot
                gu += (qt * kt * dov).sum(0)
                ds = ds * wf[:, :, t, :, None] + outer
    gw = gw * _clip_mask(w).to(f)
    return (gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype), gw.to(w.dtype),
            None if u is None else gu.to(u.dtype))
