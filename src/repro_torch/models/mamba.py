"""Mamba2 (SSD) block: the JAX package's ``models/mamba.py`` ``_dims``,
``init_mamba_block``, ``_causal_conv``, ``mamba_block`` and
``init_mamba_state``.

Block (arXiv:2405.21060, as used by Zamba2):
  in_proj -> [z | x | B | C | dt]     (d_inner, d_inner, N, N, H)
  causal depthwise conv (width 4) over [x|B|C]
  dt = softplus(dt + dt_bias);  a_t = exp(-exp(A_log) * dt)   (per head)
  SSD recurrence  h_t = a_t h_{t-1} + B_t^T (dt_t x_t);  y_t = C_t h_t + D x_t
  gate y * silu(z), RMSNorm, out_proj.

Where the reference runs ``scan_ops.linear_scan_chunked`` (its jnp analogue
of the Pallas kernel), the port calls the hand-written `linear_scan`
kernel with q = C, k = B, v = dt·x and the scalar decay per head, B, C and
the decay passed as broadcast views (n_groups = 1). A prefill starts from a
zero state, as the reference's does, and returns the state it ends in.
Decode state: the conv tail (B, width-1, conv channels) and the SSM state
(B, H, N, hd) in float32. A one-token step with a carried state runs
``scan_ops.step`` (plain PyTorch, as the reference's is jnp) and writes
the new state into the given tensors in place; the reference returns new
ones. A prefill from a carried state (the reference's chunked scan with an
initial state) is not ported: the kernel starts from zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models import layers, scan_ops
from repro_torch.models.layers import dense_init, matmul


def _dims(cfg):
    """(d_inner, head_dim, heads, state dim N, conv channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    h = d_inner // hd
    n = cfg.ssm_state_dim
    conv_ch = d_inner + 2 * n           # x | B | C
    return d_inner, hd, h, n, conv_ch


def init_mamba_block(cfg, *, generator, device):
    """The reference's init laws: in_proj and out_proj at 1/sqrt(d_in),
    conv weights N(0, 0.1²), zero conv bias and dt_bias, A_log 0 (A = -1),
    D 1, unit RMSNorm scales."""
    d = cfg.d_model
    d_inner, hd, h, n, conv_ch = _dims(cfg)
    dt = layers.dtype_of(cfg)
    proj_out = 2 * d_inner + 2 * n + h
    conv_w = torch.randn(cfg.ssm_conv_width, conv_ch, generator=generator,
                         device=device) * 0.1
    return layers.params(
        ln=layers.init_rmsnorm(d, device),
        in_proj=dense_init(generator, d, proj_out, dt, device),
        conv_w=conv_w.to(dt),
        conv_b=torch.zeros(conv_ch, dtype=dt, device=device),
        dt_bias=torch.zeros(h, dtype=torch.float32, device=device),
        a_log=torch.zeros(h, dtype=torch.float32, device=device),
        d_skip=torch.ones(h, dtype=torch.float32, device=device),
        out_norm=layers.init_rmsnorm(d_inner, device),
        out_proj=dense_init(generator, d_inner, d, dt, device))


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv. x: (B,S,C), w: (W,C), b: (C,); tail:
    (B,W-1,C), the inputs before x, or None for zeros -> (silu(conv + b)
    in x's dtype, the new tail: the last W-1 inputs). The conv is the sum
    of W shifted scalings in x's dtype, as the reference computes it."""
    width, s = w.shape[0], x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    return F.silu((y + b).float()).to(x.dtype), xp[:, s:, :]


def mamba_block(p, cfg, x, state=None):
    """x: (B,S,d) -> (x + the block's output, state). With `state` None the
    block runs the `linear_scan` kernel from a zero state and returns the
    state it ends in (conv tail, SSM state); with a state (S must be 1) it
    steps that state, written in place, and returns it."""
    b, s, _ = x.shape
    d_inner, hd, h, n, conv_ch = _dims(cfg)
    if state is not None and s != 1:
        raise ValueError(f"a carried state steps one token, got S = {s}; "
                         f"a prefill starts from a zero state (state=None)")
    xn = layers.rms_norm(p.ln, x, cfg.norm_eps)
    zxbcdt = matmul(xn, p.in_proj)
    z = zxbcdt[..., :d_inner]
    xbc, tail = _causal_conv(zxbcdt[..., d_inner:d_inner + conv_ch],
                             p.conv_w, p.conv_b,
                             None if state is None else state["conv"])
    dt_raw = zxbcdt[..., -h:].float()
    xs = xbc[..., :d_inner].reshape(b, s, h, hd)
    bb = xbc[..., d_inner:d_inner + n]                    # (B,S,N) group=1
    cc = xbc[..., d_inner + n:]

    dt_v = F.softplus(dt_raw + p.dt_bias)                 # (B,S,H)
    a = torch.exp(-torch.exp(p.a_log) * dt_v)             # (B,S,H) in (0,1)

    # heads axis first; B, C and the decay broadcast over H (and the
    # decay over N) as views, which the kernel reads through their strides
    q = cc[:, None].expand(b, h, s, n)
    k = bb[:, None].expand(b, h, s, n)
    v = (xs * dt_v[..., None]).transpose(1, 2)            # (B,H,S,hd)
    w = a.transpose(1, 2)[..., None].expand(b, h, s, n)
    if state is None:
        o, ssm = linear_scan(q, k, v, w)
        state = {"conv": tail, "ssm": ssm}
    else:
        _, o = scan_ops.step(state["ssm"], q[:, :, 0], k[:, :, 0],
                             v[:, :, 0], w[:, :, 0])
        o = o[:, :, None, :]
        state["conv"].copy_(tail)

    y = o.transpose(1, 2) + xs * p.d_skip[:, None]
    y = y.reshape(b, s, d_inner)
    y = y.float() * F.silu(z.float())
    y = layers.rms_norm(p.out_norm, y.to(x.dtype), cfg.norm_eps)
    return x + matmul(y, p.out_proj), state


def init_mamba_state(cfg, batch, dtype=torch.float32, *, device):
    """Zeroed decode state of one block: ``conv`` (B, W-1, conv channels)
    in `dtype` and ``ssm`` (B, H, N, hd) in float32."""
    _, hd, h, n, conv_ch = _dims(cfg)
    return {"conv": torch.zeros(batch, cfg.ssm_conv_width - 1, conv_ch,
                                dtype=dtype, device=device),
            "ssm": torch.zeros(batch, h, n, hd, dtype=torch.float32,
                               device=device)}
