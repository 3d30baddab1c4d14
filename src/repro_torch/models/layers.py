"""Foundational layers: norms, embeddings, MLPs, RoPE, initializers (the
JAX package's ``models/layers.py``).

Parameters live in plain `torch.nn.Module`s built by `params`, one per
dict of the JAX package's parameter pytree, with the same names: an
``init_*`` function returns the module and an apply function takes it, so
the two packages' weights map name for name. Weights are made without
gradients, for scoring; the trainer (`launch.train`) turns them on.

dtype policy, as in the reference: parameters are stored in cfg.dtype (bf16
in production configs); matmuls accumulate in float32 and return x's
dtype; norms, activations and softmax run in float32.

Under a mesh (`meshctx.mesh_context`) with ``cfg.shard_activations`` and a
"model" axis of more than one rank, `matmul_rowparallel` splits its product
over that axis: each rank multiplies its rows of w by its columns of x and
one all-reduce adds the parts.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.models import meshctx

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype of cfg.dtype."""
    return _DTYPES[cfg.dtype]


def params(**members) -> nn.Module:
    """A module holding `members` under their names: tensors as parameters
    without gradients, modules as submodules."""
    m = nn.Module()
    for name, value in members.items():
        if isinstance(value, torch.Tensor):
            value = nn.Parameter(value, requires_grad=False)
        setattr(m, name, value)
    return m


def truncated_normal(generator, shape, scale, dtype, device):
    """Standard normal truncated to [-2, 2], times `scale` (the law of the
    reference's ``jax.random.truncated_normal(key, -2, 2)``; the numbers
    come from `generator`, so they differ from the reference's)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


def dense_init(generator, d_in, d_out, dtype, device):
    """A (d_in, d_out) projection at scale 1/sqrt(d_in)."""
    return truncated_normal(generator, (d_in, d_out), 1.0 / np.sqrt(d_in),
                            dtype, device)


def matmul(x, w):
    """x @ w over the last dim of x, in x's dtype (cuBLAS accumulates bf16
    products in float32)."""
    return torch.matmul(x, w)


def matmul_rowparallel(x, w, cfg):
    """x @ w as a row-parallel (partial-sum) product: under a mesh whose
    model group has m > 1 ranks, with ``cfg.shard_activations`` (the
    reference's condition for its parallel paths) and m dividing w's rows,
    rank r multiplies its block r of w's rows by the matching columns of x
    in x's dtype, and one all-reduce over the group adds the m parts in
    x's dtype (the reference emits the local product in the model dtype so
    that its all-reduce moves bf16: each local product still accumulates
    in float32, only the sum of the m parts rounds in bf16). Otherwise,
    and where m does not divide the rows (the reference's spec then keeps
    w whole), it is `matmul`. x and w are whole on every rank."""
    mesh = meshctx.current_mesh()
    m = meshctx.model_size(mesh)
    if cfg is None or not cfg.shard_activations or m <= 1 \
            or w.shape[0] % m:
        return matmul(x, w)
    group, r, _ = meshctx.model_group(mesh)
    n = w.shape[0] // m
    part = matmul(x[..., r * n:(r + 1) * n], w[r * n:(r + 1) * n])
    dist.all_reduce(part, group=group)
    return part


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def init_rmsnorm(d, device):
    """An RMSNorm's float32 scale, all ones."""
    return params(scale=torch.ones(d, dtype=torch.float32, device=device))


def rms_norm(p, x, eps=1e-5):
    """x · rsqrt(mean(x²) + eps) · scale, in float32, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding + output head
# --------------------------------------------------------------------------

def init_embedding(generator, vocab, d, dtype, device):
    """A (vocab, d) table of unit-scale truncated normals."""
    return params(table=truncated_normal(generator, (vocab, d), 1.0, dtype,
                                         device))


def embed(p, tokens):
    """Rows of the table at `tokens`."""
    return p.table[tokens]


def unembed(p, x):
    """Logits through the (optionally tied) embedding table, float32."""
    return torch.matmul(x.float(), p.table.float().t())


def init_lm_head(generator, d, vocab, dtype, device):
    """An untied (d, vocab) output head."""
    return params(w=dense_init(generator, d, vocab, dtype, device))


def lm_head(p, x):
    """Logits through an untied head, float32."""
    return torch.matmul(x.float(), p.w.float())


def codebook_heads(p, x):
    """Logits (..., K, V) float32 of x (..., d) through K untied heads w
    (K,d,V), each from float32 operands (the reference's
    ``preferred_element_type``)."""
    return torch.einsum("...d,kdv->...kv", x.float(), p.w.float())


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU family)
# --------------------------------------------------------------------------

def init_mlp(generator, d, d_ff, dtype, device):
    """Gate, up and down projections of a gated MLP."""
    return params(w_gate=dense_init(generator, d, d_ff, dtype, device),
                  w_up=dense_init(generator, d, d_ff, dtype, device),
                  w_down=dense_init(generator, d_ff, d, dtype, device))


def mlp(p, x, act="silu", cfg=None):
    """down(act(gate(x)) · up(x)); the activation in float32, cast back.
    gelu is the tanh form, as ``jax.nn.gelu``'s default. The down
    projection is `matmul_rowparallel` under `cfg`."""
    g = matmul(x, p.w_gate)
    u = matmul(x, p.w_up)
    if act == "silu":
        h = F.silu(g.float()).to(x.dtype) * u
    elif act == "gelu":
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    else:
        raise ValueError(act)
    return matmul_rowparallel(h, p.w_down, cfg)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim, theta):
    """(head_dim/2,) float32 inverse frequencies, the reference's numpy."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponents)


@functools.lru_cache(maxsize=None)
def _device_frequencies(head_dim, theta, device):
    """`rope_frequencies` on `device`, copied there once: a copy from the
    host at every call would wait for the device each time. A normal
    tensor, though the first call may come in inference mode."""
    with torch.inference_mode(False):
        return torch.from_numpy(rope_frequencies(head_dim, theta)).to(
            device)


def rope_angles(positions, head_dim, theta):
    """positions: (...,) int -> (..., head_dim/2) angles, float32."""
    freqs = _device_frequencies(head_dim, theta, positions.device)
    return positions.float()[..., None] * freqs


def apply_rope(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotate-half
    layout: the first and second halves of head_dim are the pairs."""
    half = x.shape[-1] // 2
    ang = rope_angles(positions, x.shape[-1], theta)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, mask=None):
    """Mean cross entropy over tokens in float32: logsumexp of the logits
    (..., vocab) minus the label's logit, averaged, or averaged under
    `mask` (its sum floored at 1). The label's logit is picked by
    `torch.gather`, the same float as the reference's where/iota sum
    (which adds zeros to it)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
