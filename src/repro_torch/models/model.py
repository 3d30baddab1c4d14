"""Top-level model API for proxy scoring, decode and training (the JAX
package's ``models/model.py``):

    model  = init(cfg, generator=g)                   an nn.Module, on cuda
    logits = apply_train(model, tokens)               (B,S,V) or (B,S,K,V)
    scores = proxy_scores(model, tokens, target)      (B,) in [0,1]
    caches = init_caches(cfg, batch, seq_len)         zeroed, on cuda
    logits, caches = apply_decode(model, tokens, caches, pos)
    loss, (ce, aux) = loss_fn(model, tokens, labels)  with autograd
    model  = params_from_reference(arrays, cfg)       the reference's weights
    arrays = params_to_reference(model)               and back
    caches = caches_from_reference(arrays, cfg)       the reference's caches

The proxy-score head is how the SUPG plane consumes a model: the score of a
record is the model's probability mass on a designated predicate token at
the last position, the A(x) the paper assumes (Sec 4.1: "executes the
proxy model over the complete set of records"). The model carries its
config as ``model.cfg``. Dense attention (with one token stream or, for
musicgen, K codebooks: K embeddings summed, K heads), MoE (with GQA or
MLA attention), hybrid Mamba2 (Zamba2) and RWKV6 models. `loss_fn` runs
with autograd (the MoE's aux loss, which `transformer.body_prefill`
returns, is part of it); `apply_train`, `last_logits`, `apply_decode`
and `init_caches` run under `torch.inference_mode`, for serving.

Decode caches are nested dicts and lists of tensors, one entry per block
(and for the hybrid one attention cache per invocation of the shared
block), where the reference stacks them on leading axes. `apply_decode`
writes them in place and returns the same structure; the reference returns
new caches (written in place by XLA under donation). Both `init_caches` and
`apply_decode` run under `torch.inference_mode`, so caches made by one are
updated by the other; caches from `caches_from_reference` are ordinary
tensors, which inference mode may update too. A decode step makes no host
sync: no read-back, no branch on a tensor's value.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mamba, rwkv, transformer


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def init(cfg, *, generator: torch.Generator, device=None) -> nn.Module:
    """A model of `cfg` with weights drawn from `generator` (a generator of
    the target device) by the reference's laws. With K > 1 codebooks the
    embedding table is (K, V, d) and the untied heads (K, d, V).
    ``device=None`` means ``cuda``, and raises without a CUDA device."""
    dev = resolve_device(device)
    dt = layers.dtype_of(cfg)
    k = cfg.num_codebooks
    if k > 1:
        embed = layers.params(table=torch.stack([
            layers.init_embedding(generator, cfg.vocab_size, cfg.d_model, dt,
                                  dev).table for _ in range(k)]))
    else:
        embed = layers.init_embedding(generator, cfg.vocab_size,
                                      cfg.d_model, dt, dev)
    members = {
        "embed": embed,
        "body": transformer.init_body(cfg, generator=generator, device=dev),
        "ln_f": layers.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        if k > 1:
            members["head"] = layers.params(w=torch.stack([
                layers.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  dt, dev) for _ in range(k)]))
        else:
            members["head"] = layers.init_lm_head(generator, cfg.d_model,
                                                  cfg.vocab_size, dt, dev)
    model = layers.params(**members)
    model.cfg = cfg
    return model


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 included, or bf16 read back from an ``.npz`` as
    raw ``|V2`` words) as a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _take(d, i):
    """Slice i of every array of a nested dict stacked on a leading axis."""
    return {k: _take(v, i) if isinstance(v, dict) else v[i]
            for k, v in d.items()}


def params_from_reference(arrays, cfg, *, device=None) -> nn.Module:
    """The port's model holding the reference's weights.

    `arrays` is the JAX package's ``model.init(key, cfg)`` pytree as nested
    dicts of numpy arrays. Every tensor keeps its name, shape and dtype
    (bf16 arrays become bf16 tensors): projections stay (d_in, d_out) and
    the port computes ``x @ w`` as the reference does, so nothing is
    transposed. The one change of layout: the reference stacks the blocks'
    weights on leading axes (``transformer._split_stack``); block i here
    holds slice i of each. A dense or RWKV6 body's ``blocks`` are stacked
    on L; a hybrid's ``mamba_super`` on (super-blocks, blocks a
    super-block), its ``mamba_tail`` on the tail's blocks, and its
    ``shared_attn`` is not stacked; an MoE body's ``pairs_dense`` and
    ``pairs_moe`` (or ``dense_prefix`` and ``moe_blocks``) each on its
    blocks, and an expert stack within a block stays (E, d_in, d_out), as
    do the K codebooks' tables and heads. `params_to_reference` is the
    inverse. ``device=None`` means ``cuda``."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)

    def tree(d):
        return layers.params(**{
            name: tree(v) if isinstance(v, dict) else _tensor(v, dev)
            for name, v in d.items()})

    def blocks(d, n):
        return nn.ModuleList(tree(_take(d, i)) for i in range(n))

    body = arrays["body"]
    if cfg.block == "mamba":
        n_super, per_super, tail = transformer.zamba_layout(cfg)
        parts = {"mamba_super": nn.ModuleList(
            blocks(_take(body["mamba_super"], i), per_super)
            for i in range(n_super)),
            "shared_attn": tree(body["shared_attn"])}
        if tail:
            parts["mamba_tail"] = blocks(body["mamba_tail"], tail)
    elif cfg.moe:
        parts = {name: blocks(body[name], n)
                 for name, _, _, n in transformer.moe_layout(cfg)}
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

def _embed(model, tokens):
    """(B,S) token ids -> (B,S,d); with K codebooks (B,S,K) -> the sum of
    the K embeddings, added one codebook after another in the table's
    dtype, as the reference's bf16 ``reduce_sum`` adds them on the CPU."""
    if model.cfg.num_codebooks == 1:
        return layers.embed(model.embed, tokens)
    table = model.embed.table
    x = table[0][tokens[..., 0]]
    for i in range(1, model.cfg.num_codebooks):
        x = x + table[i][tokens[..., i]]
    return x


def _head(model, x):
    """Float32 logits (..., V), or (..., K, V) with K codebooks."""
    if model.cfg.tie_embeddings:
        return layers.unembed(model.embed, x)
    if model.cfg.num_codebooks > 1:
        return layers.codebook_heads(model.head, x)
    return layers.lm_head(model.head, x)


def _tokens(model, tokens) -> torch.Tensor:
    """Token ids as int64 on the model's device."""
    return torch.as_tensor(tokens, device=model.embed.table.device).long()


def _forward(model, tokens):
    """Final-block hidden states (B,S,d) of `tokens` (B,S) ints, or
    (B,S,K) with K codebooks, and the MoE aux loss."""
    tokens = _tokens(model, tokens)
    b, s = tokens.shape[:2]
    x = _embed(model, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    return transformer.body_prefill(model.body, model.cfg, x, positions)


def _logits(model, tokens):
    """Float32 logits over the full sequence and the MoE aux loss."""
    x, aux = _forward(model, tokens)
    return _head(model, layers.rms_norm(model.ln_f, x,
                                        model.cfg.norm_eps)), aux


@torch.inference_mode()
def apply_train(model, tokens) -> torch.Tensor:
    """Logits (B,S,V), or (B,S,K,V) with K codebooks, in float32 over the
    full sequence."""
    return _logits(model, tokens)[0]


@torch.inference_mode()
def last_logits(model, tokens) -> torch.Tensor:
    """Logits (B,V), or (B,K,V), in float32 at the last position: ln_f and
    the head are applied to that position only (the full (B,S,V) float32
    logits are 25 GB at 512 x 256 x 49152)."""
    x = _forward(model, tokens)[0][:, -1]
    return _head(model, layers.rms_norm(model.ln_f, x, model.cfg.norm_eps))


def proxy_scores(model, tokens, target_token=1) -> torch.Tensor:
    """A(x) in [0,1], (B,) float32: the probability of `target_token` at
    the last step; with K codebooks, of the K heads' logits averaged."""
    last = last_logits(model, tokens)
    if model.cfg.num_codebooks > 1:
        last = last.mean(dim=1)
    return torch.softmax(last, dim=-1)[..., target_token]


def loss_fn(model, tokens, labels, mask=None):
    """(ce + aux, (ce, aux)): the float32 cross entropy of the next-token
    labels (B,S), or (B,S,K) over every codebook (unmasked, as the
    reference's), plus the MoE aux loss (0 for the other families). Runs
    with autograd where it is enabled: nothing here is in inference
    mode."""
    logits, aux = _logits(model, tokens)
    labels = _tokens(model, labels)
    if model.cfg.num_codebooks > 1:
        ce = layers.softmax_cross_entropy(
            logits.reshape(-1, model.cfg.vocab_size), labels.reshape(-1))
    else:
        if mask is not None:
            mask = torch.as_tensor(mask, device=labels.device)
        ce = layers.softmax_cross_entropy(logits, labels, mask)
    return ce + aux, (ce, aux)


@torch.inference_mode()
def apply_decode(model, tokens, caches, pos):
    """tokens: (B,1) ints, or (B,1,K) with K codebooks; pos: (B,) ints
    (each row's position) -> (logits (B,1,V) or (B,1,K,V) float32,
    caches), `caches` written in place."""
    dev = model.embed.table.device
    tokens = _tokens(model, tokens)
    pos = torch.as_tensor(pos, device=dev).long()
    x = _embed(model, tokens)
    x, caches = transformer.body_decode(model.body, model.cfg, x, caches,
                                        pos)
    x = layers.rms_norm(model.ln_f, x, model.cfg.norm_eps)
    return _head(model, x), caches


# --------------------------------------------------------------------------
# Cache construction
# --------------------------------------------------------------------------

def _attn_cache(cfg, batch, seq_len, dtype, device):
    spec = (attention.mla_cache_spec if cfg.use_mla
            else attention.gqa_cache_spec)(cfg, batch, seq_len, dtype)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in spec.items()}


@torch.inference_mode()
def init_caches(cfg, batch, seq_len, dtype=torch.bfloat16, *, device=None):
    """Zeroed decode caches of `cfg` for `batch` rows and `seq_len`
    positions, as `apply_decode` takes them. Dense: ``blocks``, a KV cache
    a block. RWKV6: ``blocks``, a state a block. Hybrid: ``mamba_super``
    (a list of lists of Mamba2 states), ``shared_attn`` (a KV cache for
    each invocation of the shared block) and ``mamba_tail``. MoE: a KV
    cache a block under `transformer.moe_layout`'s cache names (``dense``
    and ``moe``, or ``dense_prefix`` and ``moe_blocks``). An MLA block's
    cache is its latent ``c`` (B, S, r_kv) and ``k_rope`` (B, S, dr), not
    K and V. KV and latent caches, conv tails and token shifts are in
    `dtype` (bf16 by default, as the reference's), the recurrent states
    float32. ``device=None`` means
    ``cuda``."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)
    if cfg.block == "rwkv":
        return {"blocks": [rwkv.init_rwkv_state(cfg, batch, dtype, device=dev)
                           for _ in range(cfg.num_layers)]}
    if cfg.block == "mamba":
        n_super, per_super, tail = transformer.zamba_layout(cfg)

        def states(n):
            return [mamba.init_mamba_state(cfg, batch, dtype, device=dev)
                    for _ in range(n)]
        caches = {"mamba_super": [states(per_super) for _ in range(n_super)],
                  "shared_attn": [_attn_cache(cfg, batch, seq_len, dtype, dev)
                                  for _ in range(n_super)]}
        if tail:
            caches["mamba_tail"] = states(tail)
        return caches
    if cfg.moe:
        return {name: [_attn_cache(cfg, batch, seq_len, dtype, dev)
                       for _ in range(n)]
                for _, name, _, n in transformer.moe_layout(cfg)}
    return {"blocks": [_attn_cache(cfg, batch, seq_len, dtype, dev)
                       for _ in range(cfg.num_layers)]}


def caches_from_reference(arrays, cfg, *, device=None):
    """The port's caches holding the reference's: `arrays` is the JAX
    package's ``init_caches``/``apply_decode`` cache pytree as nested dicts
    of numpy arrays, stacked on leading axes (the blocks; for the hybrid's
    Mamba2 states the super-blocks, then the blocks of one). Entry i of a
    list here holds slice i; every array keeps its dtype. ``device=None``
    means ``cuda``."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else _tensor(v, dev)
                for k, v in d.items()}

    def entries(d, n):
        return [tree(_take(d, i)) for i in range(n)]
    if cfg.moe:
        return {name: entries(arrays[name], n)
                for _, name, _, n in transformer.moe_layout(cfg)}
    if cfg.block != "mamba":
        return {"blocks": entries(arrays["blocks"], cfg.num_layers)}
    n_super, per_super, tail = transformer.zamba_layout(cfg)
    caches = {"mamba_super": [entries(_take(arrays["mamba_super"], i),
                                      per_super) for i in range(n_super)],
              "shared_attn": entries(arrays["shared_attn"], n_super)}
    if tail:
        caches["mamba_tail"] = entries(arrays["mamba_tail"], tail)
    return caches


# --------------------------------------------------------------------------
# Analytic parameter counts (roofline denominators)
# --------------------------------------------------------------------------

def count_params_analytic(cfg, active_only=False):
    """Parameter count from the config alone, by the reference's formula
    for the families the port runs (dense attention, MoE with GQA or MLA,
    hybrid Mamba2, RWKV6; embeddings and untied heads count K times with K
    codebooks). The hybrid's shared block counts once, however
    often it runs. MLA counts its down- and up-projections and wo, not its
    two RMSNorms.
    RWKV6 counts the projections and the low-rank mixes, not the vectors
    (mixes, decay base, bonus, norms), as the reference does. An MoE body
    counts num_experts routed experts a block, or with `active_only`
    num_experts_per_tok of them; a dense-prefix body counts first_k_dense
    dense blocks, as the reference does, though where that is 0 it builds
    and runs one (`transformer.moe_layout`)."""
    transformer.check_supported(cfg)
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.num_layers
    total = cfg.vocab_size * d * cfg.num_codebooks \
        * (1 if cfg.tie_embeddings else 2)
    if cfg.block == "rwkv":
        lora = cfg.rwkv_lora_dim
        per = 5 * d * d + d * cfg.d_ff * 2 + d * d   # tm + cm projections
        per += 5 * lora * d * 2 + 2 * lora * d * 2
        return total + L * per
    attn = d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) \
        + cfg.num_heads * hd * d
    mlp = 3 * d * (cfg.dense_d_ff or cfg.d_ff)
    if cfg.block == "mamba":
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state_dim
        h = d_in // cfg.ssm_head_dim
        per = d * (2 * d_in + 2 * n + h) + d_in * d
        return total + L * per + attn + mlp
    if cfg.use_mla:
        h = cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        q_in = cfg.q_lora_rank or d
        attn = d * cfg.q_lora_rank + q_in * h * (dn + dr) \
            + d * (cfg.kv_lora_rank + dr) \
            + cfg.kv_lora_rank * h * (dn + dv) + h * dv * d
    if cfg.moe:
        expert = 3 * d * cfg.moe_d_ff
        shared = expert * cfg.num_shared_experts
        router = d * cfg.num_experts
        if cfg.moe_layer_step > 1:
            n_moe = L // cfg.moe_layer_step
            n_dense = L - n_moe
        else:
            n_moe = L - cfg.first_k_dense
            n_dense = cfg.first_k_dense
        experts = cfg.num_experts_per_tok if active_only \
            else cfg.num_experts
        return total + L * attn + n_dense * mlp \
            + n_moe * (expert * experts + shared + router)
    return total + L * (attn + mlp)


def train_flops_analytic(cfg, batch, seq):
    """6·N_active·D plus attention's quadratic term, the reference's
    §Roofline MODEL_FLOPS of a training step over `batch` x `seq`
    tokens."""
    n_active = count_params_analytic(cfg, active_only=True)
    flops = 6.0 * n_active * batch * seq
    if cfg.num_heads and cfg.block == "attn":
        hd = cfg.head_dim if not cfg.use_mla else (
            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
        # causal: 2 matmuls * S^2/2 * heads * hd, *3 for fwd+bwd, per layer
        flops += 3.0 * 2.0 * batch * seq * seq * cfg.num_heads * hd \
            * cfg.num_layers / 2.0
    return flops


# --------------------------------------------------------------------------
# The reference's parameter layout
# --------------------------------------------------------------------------

def reference_path(name: str):
    """Where the port's parameter `name` lies in the reference's pytree:
    (its keys, its indices on the leading stacked axes). Each block index
    in a name (a position in an `nn.ModuleList`) is a stacked axis of the
    reference: ``body.blocks.3.ln1.scale`` is ``body/blocks/ln1/scale``
    [3], ``body.mamba_super.2.4.in_proj`` is ``[2, 4]`` of its stack."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The number of dims of `name`'s leaf in the reference's stacked
    pytree: p's own, plus one for each stacked axis it sits on."""
    return p.ndim + len(reference_path(name)[1])


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 as the raw 2-byte words
    numpy writes bf16 arrays as (``|V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def to_reference(named) -> dict:
    """Tensors keyed by the port's parameter names -> the reference's
    nested dicts of numpy arrays on the host (bf16 as ``|V2``), each
    block's slices stacked on the leading axes, keys in sorted order (as
    ``jax.tree`` flattens them)."""
    groups: dict = {}
    for name, t in named.items():
        keys, index = reference_path(name)
        groups.setdefault(keys, []).append((index, t))
    tree: dict = {}
    for keys, entries in groups.items():
        entries.sort(key=lambda e: e[0])
        shape = tuple(max(i[a] for i, _ in entries) + 1
                      for a in range(len(entries[0][0])))
        leaf = np.stack([_numpy(t) for _, t in entries])
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf.reshape(shape + leaf.shape[1:])

    def ordered(d):
        return {k: ordered(d[k]) if isinstance(d[k], dict) else d[k]
                for k in sorted(d)}
    return ordered(tree)


def from_reference(arrays, names, *, device) -> dict:
    """The inverse of `to_reference` for the parameter `names`: each
    name's slice of the reference's stacked arrays, as a tensor on
    `device` (``|V2`` arrays as bf16)."""
    out = {}
    for name in names:
        keys, index = reference_path(name)
        node = arrays
        for k in keys:
            node = node[k]
        out[name] = _tensor(np.asarray(node)[index], device)
    return out


def params_to_reference(model) -> dict:
    """The reference's ``model.init`` pytree of the port's model, as nested
    dicts of numpy arrays: the inverse of `params_from_reference`."""
    return to_reference(dict(model.named_parameters()))
