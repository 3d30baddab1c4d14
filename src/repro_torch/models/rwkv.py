"""RWKV6 "Finch" block: the JAX package's ``models/rwkv.py``, attention-free
time-mix with data-dependent decay (arXiv:2404.05892).

  time-mix : token-shift ddlerp (low-rank data-dependent interpolation) into
             r/k/v/g/w projections; per-channel, per-token decay
             w_t = exp(-exp(w0 + lora_w(x_w))) and bonus u for the current
             token; the wkv linear recurrence; per-head group norm, silu(g)
             gate, output projection.
  channel-mix : token-shift squared-relu MLP with receptance gate.

State per block for decode: shift_tm (B,d), shift_cm (B,d) in the cache
dtype, wkv (B,H,hd,hd) in float32.

Where the reference's prefill runs ``scan_ops.linear_scan_chunked`` (its
jnp analogue of the Pallas kernel), the port calls the hand-written
`linear_scan` kernel in its RWKV6 mode (bonus u, a decay per state row),
from a zero state; on the card that is the channel route (the chunked
kernel with a decay per channel). v goes in as it is, bf16 in a bf16
model, and o comes back in v's dtype: the kernel and its plain version
compute in float32 inside and round o once, as the reference's scan does.
A one-token step with a carried state runs ``scan_ops.step`` (plain
PyTorch, as the reference's is jnp) and writes the new states into the
given tensors in place; the reference returns new ones. A prefill from a
carried wkv state is not ported: the kernel starts from zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models import layers, scan_ops
from repro_torch.models.layers import dense_init, matmul

_MIX_NAMES = ("w", "k", "v", "r", "g")


def _heads(cfg):
    """(heads, head dim) of the wkv recurrence."""
    return cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim


def init_rwkv_block(cfg, *, generator, device):
    """The reference's init laws: projections at 1/sqrt(d_in) in
    cfg.dtype; the mixing parameters mu_x, mu, cm_mu_k and cm_mu_r zero,
    w0 = -6 and the bonus u N(0, 0.1²), all float32; maa_w2 and wd2
    N(0, 0.01²) in cfg.dtype; unit RMSNorm scales."""
    d, lora = cfg.d_model, cfg.rwkv_lora_dim
    h, hd = _heads(cfg)
    dt = layers.dtype_of(cfg)
    n_mix = len(_MIX_NAMES)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=device)

    def normal(*shape, scale):
        return torch.randn(*shape, generator=generator, device=device) \
            * scale

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, dt, device)
    return layers.params(
        ln_tm=layers.init_rmsnorm(d, device),
        ln_cm=layers.init_rmsnorm(d, device),
        mu_x=zeros(d),
        mu=zeros(n_mix, d),
        maa_w1=dense(d, n_mix * lora),
        maa_w2=normal(n_mix, lora, d, scale=0.01).to(dt),
        wr=dense(d, d), wk=dense(d, d), wv=dense(d, d), wg=dense(d, d),
        wo=dense(d, d),
        w0=zeros(d) - 6.0,
        wd1=dense(d, 2 * lora),
        wd2=normal(2 * lora, d, scale=0.01).to(dt),
        u=normal(h, hd, scale=0.1),
        ln_x=layers.init_rmsnorm(d, device),
        cm_mu_k=zeros(d),
        cm_mu_r=zeros(d),
        cm_wk=dense(d, cfg.d_ff),
        cm_wv=dense(cfg.d_ff, d),
        cm_wr=dense(d, d))


def _shift(x, state):
    """Token shift: the previous token's activation; `state` (B,d) carries
    t = -1 (None for zeros)."""
    if state is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([state[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(p, x, xx):
    """Data-dependent interpolation producing the 5 mixed inputs, in the
    order w, k, v, r, g."""
    base = x + xx * p.mu_x.to(x.dtype)
    lora = torch.tanh(matmul(base, p.maa_w1).float())
    lora = lora.reshape(*lora.shape[:-1], len(_MIX_NAMES), -1)
    delta = torch.einsum("...nl,nld->...nd", lora, p.maa_w2.float())
    return [x + xx * (p.mu[i] + delta[..., i, :]).to(x.dtype)
            for i in range(len(_MIX_NAMES))]


def time_mix(p, cfg, x, shift_state=None, wkv_state=None):
    """x: (B,S,d) -> (y, new shift state, new wkv state). With no wkv state
    the recurrence runs in the `linear_scan` kernel from a zero state; with
    one (S must be 1) it steps that state, written in place."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    if wkv_state is not None and s != 1:
        raise ValueError(f"a carried state steps one token, got S = {s}; "
                         f"a prefill starts from a zero state")
    xx = _shift(x, shift_state) - x
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xx)

    def heads(t):
        return t.reshape(b, s, h, hd).transpose(1, 2)     # (B,H,S,hd)
    r = heads(matmul(x_r, p.wr))
    k = heads(matmul(x_k, p.wk))
    v = heads(matmul(x_v, p.wv))
    g = F.silu(matmul(x_g, p.wg).float())

    dw = torch.tanh(matmul(x_w, p.wd1).float()) @ p.wd2.float()
    logw = -torch.exp(torch.clamp(p.w0 + dw, -20.0, 8.0))   # <= 0
    w = heads(torch.exp(logw))              # float32, a decay per channel

    if wkv_state is None:
        o, wkv_state = linear_scan(r, k, v, w, p.u)
    else:
        _, o = scan_ops.step(wkv_state, r[:, :, 0], k[:, :, 0], v[:, :, 0],
                             w[:, :, 0], p.u)
        o = o[:, :, None, :]
    # per-head group norm (RWKV's GroupNorm(n_heads)): over hd in a head
    of = o.transpose(1, 2).float()                         # (B,S,H,hd)
    var = torch.mean(of * of, dim=-1, keepdim=True)
    o = (of * torch.rsqrt(var + cfg.norm_eps)
         * p.ln_x.scale.reshape(h, hd)).reshape(b, s, d)
    y = matmul((o * g).to(x.dtype), p.wo)
    return y, x[:, -1, :], wkv_state


def channel_mix(p, cfg, x, shift_state=None):
    """x: (B,S,d) -> (y, new shift state): relu(k)² through cm_wv, gated
    by sigmoid(r)."""
    xx = _shift(x, shift_state) - x
    xk = x + xx * p.cm_mu_k.to(x.dtype)
    xr = x + xx * p.cm_mu_r.to(x.dtype)
    kk = torch.square(F.relu(matmul(xk, p.cm_wk).float()))
    vv = matmul(kk.to(x.dtype), p.cm_wv)
    rr = torch.sigmoid(matmul(xr, p.cm_wr).float())
    return (rr * vv.float()).to(x.dtype), x[:, -1, :]


def rwkv_block(p, cfg, x, state=None):
    """The pre-norm RWKV6 block: x: (B,S,d) -> (x + time-mix + channel-mix,
    state), state a dict (shift_tm, shift_cm, wkv). With `state` None the
    block runs from zeros and returns the state it ends in; with a state
    (S must be 1) it writes the new states into it and returns it."""
    h_tm, shift_tm, wkv = time_mix(
        p, cfg, layers.rms_norm(p.ln_tm, x, cfg.norm_eps),
        None if state is None else state["shift_tm"],
        None if state is None else state["wkv"])
    x = x + h_tm
    h_cm, shift_cm = channel_mix(
        p, cfg, layers.rms_norm(p.ln_cm, x, cfg.norm_eps),
        None if state is None else state["shift_cm"])
    x = x + h_cm
    if state is None:
        return x, {"shift_tm": shift_tm, "shift_cm": shift_cm, "wkv": wkv}
    state["shift_tm"].copy_(shift_tm)
    state["shift_cm"].copy_(shift_cm)
    return x, state


def init_rwkv_state(cfg, batch, dtype=torch.float32, *, device):
    """Zeroed decode state of one block: shift_tm and shift_cm (B,d) in
    `dtype`, wkv (B,H,hd,hd) in float32."""
    h, hd = _heads(cfg)
    return {"shift_tm": torch.zeros(batch, cfg.d_model, dtype=dtype,
                                    device=device),
            "shift_cm": torch.zeros(batch, cfg.d_model, dtype=dtype,
                                    device=device),
            "wkv": torch.zeros(batch, h, hd, hd, dtype=torch.float32,
                               device=device)}
