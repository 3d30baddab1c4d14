"""Mixture-of-Experts: top-k routing, capacity-based sort dispatch, shared
experts (the JAX package's ``models/moe.py`` ``init_moe``,
``top_k_routing`` and ``moe_apply`` by ``_moe_apply_dense``). Covers
llama4-maverick (128 routed top-1 + 1 shared, sigmoid gate) and the MoE
widths of deepseek-v2 (160 routed top-6 + 2 shared, softmax gates).

Dispatch is the sort-based capacity scheme (GShard/MaxText style): tokens
-> a stable argsort by expert id -> positions within each expert -> a
scatter into an (E, C, d) buffer -> batched per-expert SwiGLU
(`torch.bmm`) -> gather and combine. Which assignments are dropped, and
which slot each kept one takes, are the reference's. What differs:

* the gates are computed in float64 and rounded to float32 (a correctly
  rounded softmax or sigmoid), so that the same router logits choose the
  same experts on every device; the reference's float32 softmax lies
  within a few ulps of them;
* in bf16, ``torch.bmm`` rounds g and u to bf16 before the silu (the
  reference accumulates them in float32 and rounds h);
* the combine adds each assignment with ``index_add_``, which adds by
  atomics on the card: with k > 1 a token's k terms add in any order.

The expert-parallel ``_moe_apply_shardmap`` waits for the mesh slice
(ROADMAP §1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import dense_init, matmul


def init_moe(cfg, *, generator, device):
    """A float32 router (d, E); stacked expert projections w_gate and w_up
    (E, d, ff) and w_down (E, ff, d) in cfg.dtype; and with shared experts
    ``shared``, one gated MLP of width moe_d_ff · num_shared_experts."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = layers.dtype_of(cfg)
    p = {"router": dense_init(generator, d, e, torch.float32, device),
         "w_gate": _stacked_init(generator, e, d, ff, dt, device),
         "w_up": _stacked_init(generator, e, d, ff, dt, device),
         "w_down": _stacked_init(generator, e, ff, d, dt, device)}
    if cfg.num_shared_experts:
        p["shared"] = layers.init_mlp(
            generator, d, ff * cfg.num_shared_experts, dt, device)
    return layers.params(**p)


def _stacked_init(generator, e, d_in, d_out, dt, device):
    """(e, d_in, d_out) in `dt`, drawn one expert at a time: a float32
    temporary of the whole stack would be 21.5 GB at llama4's widths."""
    w = torch.empty((e, d_in, d_out), dtype=dt, device=device)
    for i in range(e):
        w[i] = dense_init(generator, d_in, d_out, dt, device)
    return w


def capacity(cfg, n):
    """Slots an expert holds for `n` tokens: capacity_factor · n · k / E,
    at least 8 and at most n (the reference's Python arithmetic)."""
    cap = int(cfg.capacity_factor * n * cfg.num_experts_per_tok
              / cfg.num_experts)
    return max(8, min(cap, n))


def top_k_routing(router_logits, k, gate_fn="softmax"):
    """(N, E) logits -> (N, k) expert ids (int64), their gates (float32)
    and every expert's gate (N, E) float32. Ties go to the lowest index,
    as ``jax.lax.top_k``'s; a softmax's k > 1 gates are renormalized."""
    logits = router_logits.double()
    gates_all = (torch.softmax(logits, dim=-1) if gate_fn == "softmax"
                 else torch.sigmoid(logits)).float()
    gate_vals, expert_ids = torch.sort(gates_all, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :k], expert_ids[..., :k]
    if gate_fn == "softmax" and k > 1:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return expert_ids, gate_vals, gates_all


def dispatch(expert_ids, num_experts, cap):
    """The sort-based dispatch of (N, k) expert ids into E · cap slots:
    (order, tok_sorted, slot, keep), each (N·k,). `order` is a stable
    argsort of the flat ids (token-major), `tok_sorted` each sorted
    assignment's token, `keep` whether it lies within its expert's first
    `cap`, and `slot` its row e · cap + position in the (E·cap + 1, d)
    buffer, the last row for a dropped one."""
    n, k = expert_ids.shape
    flat_e = expert_ids.reshape(n * k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = order // k
    starts = torch.searchsorted(
        e_sorted, torch.arange(num_experts, device=flat_e.device),
        side="left")
    pos_in_e = torch.arange(n * k, device=flat_e.device) - starts[e_sorted]
    keep = pos_in_e < cap
    slot = torch.where(keep, e_sorted * cap + pos_in_e,
                       torch.full_like(e_sorted, num_experts * cap))
    return order, tok_sorted, slot, keep


def moe_apply(p, cfg, x, gate_fn="softmax"):
    """x: (B, S, d) -> ((B, S, d) in x's dtype, the Switch load-balancing
    aux loss, a float32 scalar): route each token to its top-k experts,
    drop the assignments past an expert's capacity, run the kept ones
    through their experts' SwiGLU and add them, weighted by their gates,
    to the shared experts' output."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(cfg, n)

    xt = x.reshape(n, d)
    router_logits = matmul(xt.float(), p.router)
    expert_ids, gate_vals, gates_all = top_k_routing(router_logits, k,
                                                     gate_fn)

    # ---- sort-based dispatch -------------------------------------------
    order, tok_sorted, slot, keep = dispatch(expert_ids, e, cap)
    g_sorted = gate_vals.reshape(n * k)[order]
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xt[tok_sorted]
    buf = buf[:-1].reshape(e, cap, d)

    # ---- batched per-expert SwiGLU --------------------------------------
    g = torch.bmm(buf, p.w_gate).float()
    u = torch.bmm(buf, p.w_up).float()
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.bmm(h, p.w_down)

    # ---- combine ---------------------------------------------------------
    y_flat = y.reshape(e * cap, d)
    contrib = torch.where(keep, g_sorted, 0.0)[:, None] \
        * y_flat[torch.clamp_max(slot, e * cap - 1)].float()
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok_sorted, torch.where(keep[:, None], contrib, 0.0))

    if cfg.num_shared_experts:
        out = out + layers.mlp(p.shared, xt, cfg.act).float()

    # Switch-style load-balancing aux loss.
    density = F.one_hot(expert_ids[:, 0], e).float().mean(dim=0)
    prob_mass = gates_all.mean(dim=0)
    aux = e * torch.sum(density * prob_mass) * cfg.router_aux_coef
    return out.reshape(b, s, d).to(x.dtype), aux
