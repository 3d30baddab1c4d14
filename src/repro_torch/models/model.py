"""Top-level model API for proxy scoring (the JAX package's
``models/model.py``):

    model  = init(cfg, generator=g)                   an nn.Module, on cuda
    logits = apply_train(model, tokens)               (B,S,V) float32
    scores = proxy_scores(model, tokens, target)      (B,) in [0,1]
    model  = params_from_reference(arrays, cfg)       the reference's weights

The proxy-score head is how the SUPG plane consumes a model: the score of a
record is the model's probability mass on a designated predicate token at
the last position, the A(x) the paper assumes (Sec 4.1: "executes the
proxy model over the complete set of records"). The model carries its
config as ``model.cfg``. Dense attention and hybrid Mamba2 (Zamba2) models
so far; decode, the loss and the other families wait for their slices
(ROADMAP §1).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def init(cfg, *, generator: torch.Generator, device=None) -> nn.Module:
    """A model of `cfg` with weights drawn from `generator` (a generator of
    the target device) by the reference's laws. ``device=None`` means
    ``cuda``, and raises without a CUDA device."""
    dev = resolve_device(device)
    dt = layers.dtype_of(cfg)
    members = {
        "embed": layers.init_embedding(generator, cfg.vocab_size,
                                       cfg.d_model, dt, dev),
        "body": transformer.init_body(cfg, generator=generator, device=dev),
        "ln_f": layers.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        members["head"] = layers.init_lm_head(generator, cfg.d_model,
                                              cfg.vocab_size, dt, dev)
    model = layers.params(**members)
    model.cfg = cfg
    return model


def params_from_reference(arrays, cfg, *, device=None) -> nn.Module:
    """The port's model holding the reference's weights.

    `arrays` is the JAX package's ``model.init(key, cfg)`` pytree as nested
    dicts of numpy arrays. Every tensor keeps its name, shape and dtype
    (bf16 arrays become bf16 tensors): projections stay (d_in, d_out) and
    the port computes ``x @ w`` as the reference does, so nothing is
    transposed. The one change of layout: the reference stacks the blocks'
    weights on leading axes (``transformer._split_stack``); block i here
    holds slice i of each. A dense body's ``blocks`` are stacked on L; a
    hybrid's ``mamba_super`` on (super-blocks, blocks a super-block), its
    ``mamba_tail`` on the tail's blocks, and its ``shared_attn`` is not
    stacked. ``device=None`` means ``cuda``."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    def tree(d):
        return layers.params(**{
            name: tree(v) if isinstance(v, dict) else tensor(v)
            for name, v in d.items()})

    def take(d, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i]
                for k, v in d.items()}

    def blocks(d, n):
        return nn.ModuleList(tree(take(d, i)) for i in range(n))

    body = arrays["body"]
    if cfg.block == "mamba":
        n_super, per_super, tail = transformer.zamba_layout(cfg)
        parts = {"mamba_super": nn.ModuleList(
            blocks(take(body["mamba_super"], i), per_super)
            for i in range(n_super)),
            "shared_attn": tree(body["shared_attn"])}
        if tail:
            parts["mamba_tail"] = blocks(body["mamba_tail"], tail)
    else:
        parts = {"blocks": blocks(body["blocks"], cfg.num_layers)}
    members = {name: tree(v) for name, v in arrays.items() if name != "body"}
    members["body"] = layers.params(**parts)
    model = layers.params(**members)
    model.cfg = cfg
    return model


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _head(model, x):
    if model.cfg.tie_embeddings:
        return layers.unembed(model.embed, x)
    return layers.lm_head(model.head, x)


def _hidden(model, tokens):
    """Final-block hidden states (B,S,d) of `tokens` (B,S) ints."""
    tokens = torch.as_tensor(tokens, device=model.embed.table.device).long()
    b, s = tokens.shape
    x = layers.embed(model.embed, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    return transformer.body_prefill(model.body, model.cfg, x, positions)


@torch.inference_mode()
def apply_train(model, tokens) -> torch.Tensor:
    """Logits (B,S,V) in float32 over the full sequence."""
    x = _hidden(model, tokens)
    return _head(model, layers.rms_norm(model.ln_f, x, model.cfg.norm_eps))


@torch.inference_mode()
def last_logits(model, tokens) -> torch.Tensor:
    """Logits (B,V) in float32 at the last position: ln_f and the head are
    applied to that position only (the full (B,S,V) float32 logits are
    25 GB at 512 x 256 x 49152)."""
    x = _hidden(model, tokens)[:, -1]
    return _head(model, layers.rms_norm(model.ln_f, x, model.cfg.norm_eps))


def proxy_scores(model, tokens, target_token=1) -> torch.Tensor:
    """A(x) in [0,1], (B,) float32: the probability of `target_token` at
    the last step."""
    p = torch.softmax(last_logits(model, tokens), dim=-1)
    return p[..., target_token]


# --------------------------------------------------------------------------
# Analytic parameter counts (roofline denominators)
# --------------------------------------------------------------------------

def count_params_analytic(cfg):
    """Parameter count from the config alone, by the reference's formula
    for the families the port runs (dense attention, hybrid Mamba2). The
    hybrid's shared block counts once, however often it runs."""
    transformer.check_supported(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    attn = d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) \
        + cfg.num_heads * hd * d
    mlp = 3 * d * (cfg.dense_d_ff or cfg.d_ff)
    if cfg.block == "mamba":
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state_dim
        h = d_in // cfg.ssm_head_dim
        per = d * (2 * d_in + 2 * n + h) + d_in * d
        return total + cfg.num_layers * per + attn + mlp
    return total + cfg.num_layers * (attn + mlp)
