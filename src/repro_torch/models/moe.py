"""Mixture-of-Experts: top-k routing, capacity-based sort dispatch, shared
experts (the JAX package's ``models/moe.py`` ``init_moe``,
``top_k_routing``, ``moe_apply``, ``_moe_apply_dense``, and the
expert-parallel ``_local_expert_ffn`` and ``_moe_apply_shardmap``). Covers
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

Expert parallelism (`_moe_apply_shardmap`): under a mesh with
``cfg.shard_activations`` and a "model" axis of m > 1 ranks dividing E,
rank r of the model group runs experts [r·E/m, (r+1)·E/m) (its Shard(0)
block of w_gate, w_up and w_down) on its data shard of x. Every model rank
routes the same tokens alike (the float32 router, then `top_k_routing`),
dispatches only the assignments to its own experts (the others go to a
discard group, as the reference's), with the capacity of its local token
count, and adds its kept assignments into a partial output in x's dtype;
one all-reduce over the group sums the partials, and the aux loss is
averaged over the data axes. The dense path runs where the condition
fails.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import layers, meshctx
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
    to the shared experts' output. Expert-parallel
    (`_moe_apply_shardmap`) under a mesh whose model group divides E, as
    the module's docstring says; dense otherwise."""
    mesh = meshctx.current_mesh()
    if cfg.shard_activations:
        m = meshctx.model_size(mesh)
        if m > 1 and cfg.num_experts % m == 0:
            return _moe_apply_shardmap(p, cfg, x, gate_fn, mesh)
    return _moe_apply_dense(p, cfg, x, gate_fn)


def _moe_apply_dense(p, cfg, x, gate_fn="softmax"):
    """`moe_apply` on one process: every expert here."""
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
        out = out + layers.mlp(p.shared, xt, cfg.act, cfg).float()

    # Switch-style load-balancing aux loss.
    density = F.one_hot(expert_ids[:, 0], e).float().mean(dim=0)
    prob_mass = gates_all.mean(dim=0)
    aux = e * torch.sum(density * prob_mass) * cfg.router_aux_coef
    return out.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------

def local_dispatch(expert_ids, first: int, e_loc: int, cap: int):
    """`dispatch` of the assignments to experts [first, first + e_loc)
    into e_loc · cap slots: the others go to a discard group e_loc, past
    the real experts, so each kept assignment has the slot it has in the
    dense dispatch's expert, less first · cap. (order, tok_sorted, slot,
    keep) as `dispatch`'s, a discarded or dropped assignment at slot
    e_loc · cap."""
    e_rel = expert_ids - first
    mine = (e_rel >= 0) & (e_rel < e_loc)
    e_rel = torch.where(mine, e_rel, torch.full_like(e_rel, e_loc))
    order, tok_sorted, slot, keep = dispatch(e_rel, e_loc + 1, cap)
    keep = keep & mine.reshape(-1)[order]
    slot = torch.where(keep, slot, torch.full_like(slot, e_loc * cap))
    return order, tok_sorted, slot, keep


def _local_expert_ffn(x_loc, router, wg, wu, wd, *, cfg, gate_fn, e_total,
                      first):
    """One rank's experts on its data shard: x_loc (B_loc, S, d), the
    whole float32 router (d, E), and wg, wu (e_loc, d, ff) and wd
    (e_loc, ff, d), experts [first, first + e_loc). -> (the partial output
    (B_loc, S, d) in x's dtype, its kept assignments only, and the local
    aux loss)."""
    b_loc, s, d = x_loc.shape
    n = b_loc * s
    e_loc = wg.shape[0]
    k = cfg.num_experts_per_tok
    cap = capacity(cfg, n)        # of the local token count

    xt = x_loc.reshape(n, d)
    expert_ids, gate_vals, gates_all = top_k_routing(matmul(xt.float(),
                                                            router), k,
                                                     gate_fn)
    order, tok_sorted, slot, keep = local_dispatch(expert_ids, first, e_loc,
                                                   cap)
    g_sorted = gate_vals.reshape(n * k)[order]
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x_loc.dtype,
                      device=x_loc.device)
    buf[slot] = xt[tok_sorted]
    buf = buf[:-1].reshape(e_loc, cap, d)

    g = torch.bmm(buf, wg).float()
    u = torch.bmm(buf, wu).float()
    h = (F.silu(g) * u).to(x_loc.dtype)
    y = torch.bmm(h, wd)

    y_flat = y.reshape(e_loc * cap, d)
    contrib = torch.where(keep, g_sorted, 0.0).to(x_loc.dtype)[:, None] \
        * y_flat[torch.clamp_max(slot, e_loc * cap - 1)]
    partial = torch.zeros((n, d), dtype=x_loc.dtype, device=x_loc.device)
    partial.index_add_(0, tok_sorted,
                       torch.where(keep[:, None], contrib, 0.0))

    density = F.one_hot(expert_ids[:, 0], e_total).float().mean(dim=0)
    prob_mass = gates_all.mean(dim=0)
    aux = e_total * torch.sum(density * prob_mass) * cfg.router_aux_coef
    return partial.reshape(b_loc, s, d), aux


def _moe_apply_shardmap(p, cfg, x, gate_fn, mesh):
    """`moe_apply` with the experts split over `mesh`'s model group: x is
    this rank's data shard (the same on every rank of its model group);
    the partial outputs are summed by one all-reduce over the group in x's
    dtype, the aux loss averaged over the data axes, and the shared
    experts added in x's dtype, as the reference does."""
    group, r, m = meshctx.model_group(mesh)
    e_loc = cfg.num_experts // m
    lo = r * e_loc
    out, aux = _local_expert_ffn(
        x, p.router, p.w_gate[lo:lo + e_loc], p.w_up[lo:lo + e_loc],
        p.w_down[lo:lo + e_loc], cfg=cfg, gate_fn=gate_fn,
        e_total=cfg.num_experts, first=lo)
    dist.all_reduce(out, group=group)
    n_data = 1
    for g in meshctx.data_groups(mesh):
        dist.all_reduce(aux, group=g)
        n_data *= dist.get_world_size(g)
    aux = aux / n_data
    if cfg.num_shared_experts:
        out = out + layers.mlp(p.shared, x, cfg.act, cfg)
    return out, aux
