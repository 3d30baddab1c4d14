"""One decode step of the diagonal-decay linear recurrence: the JAX
package's ``models/scan_ops.py`` ``step``.

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    o_t = q_t S_t                            (Mamba2: u is None)
    o_t = q_t (S_{t-1} + diag(u) k_tᵀ v_t)    (RWKV6: bonus u)

The reference computes it with jnp outside any Pallas kernel, so it is
plain PyTorch here too; the whole-sequence forms (``linear_scan_recurrent``,
``linear_scan_chunked``) are the `linear_scan` kernel's
(``kernels/linear_scan``). The rounding is the reference's as its decode
runs it, compiled: k_tᵀ v_t, the state and the read in float32, o cast to
v's dtype. (Op by op, the reference's step would round k_tᵀ v_t to bf16
for an RWKV6 bf16 model's k and v; compiled, as ``apply_decode`` runs it
inside ``lax.scan``, XLA drops that rounding, and the float32 product is
also what the prefill's scan computes.) Unlike the kernel, w is not
clipped, as the reference's step does not clip it. What differs: the new
state is written into the carried state, in place (a decode step updates
its cache), where the reference returns a new one.
"""
from __future__ import annotations

import torch


def step(state, qt, kt, vt, wt, u=None):
    """state: (B,H,dk,dv) float32, updated in place; qt, kt, wt: (B,H,dk);
    vt: (B,H,dv); u: (H,dk) or None -> (state, o (B,H,dv) in vt's
    dtype)."""
    kv = kt.float()[..., :, None] * vt.float()[..., None, :]
    if u is not None:
        read = state + u[None, :, :, None] * kv
        o = torch.einsum("bhk,bhkv->bhv", qt.float(), read)
    state.mul_(wt[..., None]).add_(kv)
    if u is None:
        o = torch.einsum("bhk,bhkv->bhv", qt.float(), state)
    return state, o.to(vt.dtype)
