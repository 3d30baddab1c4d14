"""The training step (the JAX package's ``launch/train.py``):
`make_train_step(cfg, options)` returns ``train_step(model, opt_state,
batch) -> (model, opt_state, metrics)``.

One step takes ``batch["tokens"]`` and ``batch["labels"]`` (numpy or
tensors, (B, S) or (B, S, K)), runs `models.model.loss_fn` forward and
backward with autograd (attention's gradient is the flash_attention
backward kernel on the card, activation checkpointing where ``cfg.remat
== "block"``) and one `optim.adamw.apply`, which updates the model and the
optimizer state in place. With ``grad_accum`` > 1 the batch's rows split
into microbatches as the reference's reshape splits them (microbatch i is
rows [i·B/n, (i+1)·B/n)); their gradients add up in float32 buffers and
are divided by the count, the loss is their mean and ``ce`` and ``aux``
are the last microbatch's. The metrics (``ce``, ``aux``, ``loss``,
``grad_norm``, ``lr``) are 0-d tensors: nothing in a step reads the device
back.

`shardings_for_train` places a step's parameters, AdamW moments (ZeRO-1:
each moment's parameter spec plus the data axes) and batch on a mesh, and
`input_specs_train` gives a shape's batch as ``meta`` tensors. The step
itself runs on one process: its gradients are not reduced over a mesh.
A config whose training path has no backward kernel raises
NotImplementedError: Mamba2 and RWKV6 blocks (linear_scan has no backward
kernel yet), and on the card attention at head dims flash_attention_bwd
does not take (it takes the forward kernel's (64, 64), (128, 128) and
(192, 128)).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import sharding as shardlib
from repro_torch.models import model as modellib
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Microbatches a step (``grad_accum``) and AdamW's settings. The
    reference's ``zero1`` is `shardings_for_train`'s argument here: the
    step runs on one process."""

    grad_accum: int = 1
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()


def attention_head_dims(cfg):
    """(q·k head dim, v head dim) of cfg's attention."""
    if cfg.use_mla:
        return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return (cfg.head_dim, cfg.head_dim)


def check_trainable(cfg, device=None) -> None:
    """Raise NotImplementedError where cfg's training path on `device`
    has no backward kernel: Mamba2 and RWKV6 blocks on any device (queued
    in ROADMAP.md), and on a CUDA device attention at head dims the
    flash_attention backward kernel does not take."""
    if cfg.block in ("mamba", "rwkv"):
        raise NotImplementedError(
            f"{cfg.name}: training {cfg.block} blocks needs a linear_scan "
            f"backward kernel, queued in ROADMAP.md")
    if device is not None and torch.device(device).type == "cuda":
        dims = attention_head_dims(cfg)
        if dims not in fa_ops.BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"{cfg.name}: the flash_attention backward kernel takes "
                f"(head_dim, v_dim) in {fa_ops.BWD_HEAD_DIMS}, not {dims}")


def make_loss_fn(cfg):
    """loss(model, tokens, labels) -> (total, {"ce", "aux"})."""
    def loss(model, tokens, labels):
        total, (ce, aux) = modellib.loss_fn(model, tokens, labels)
        return total, {"ce": ce, "aux": aux}
    return loss


def make_train_step(cfg, options: TrainOptions = TrainOptions()):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics); see the module's docstring."""
    check_trainable(cfg)
    loss_fn = make_loss_fn(cfg)

    def value_and_grad(model, params, tokens, labels):
        loss, metrics = loss_fn(model, tokens, labels)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        device = next(iter(params.values())).device
        check_trainable(cfg, device)
        for p in params.values():
            p.requires_grad_(True)
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        n = options.grad_accum
        if n > 1:
            mb_tok = tokens.reshape((n, tokens.shape[0] // n)
                                    + tokens.shape[1:])
            mb_lab = labels.reshape(mb_tok.shape[:2] + labels.shape[1:])
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                   for p in params.values()]
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n):
                loss, metrics, grads = value_and_grad(model, params,
                                                      mb_tok[i], mb_lab[i])
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
                loss_sum = loss_sum + loss
            grads = [a.div_(n) for a in acc]
            loss_val = loss_sum / n
        else:
            loss_val, metrics, grads = value_and_grad(model, params, tokens,
                                                      labels)
        model, opt_state, opt_metrics = adamw.apply(
            options.adamw, model, dict(zip(params, grads)), opt_state)
        metrics = dict(metrics, loss=loss_val, **opt_metrics)
        return model, opt_state, metrics

    return train_step


def shardings_for_train(cfg, params, opt_state, mesh, batch_ndim=2,
                        zero1=True, fsdp=False, batch_size=None):
    """(in, out) `launch.sharding.Sharding`s of a train step on `mesh`:
    ((params, AdamWState(step, mu, nu), {"tokens", "labels"}), (params,
    opt_state, None)). Under ``cfg.train_parallelism`` "dp" the parameters
    and moments are split over every axis and the batch too; under "tp"
    the moments get ZeRO-1's specs where `zero1`. `params` is the model or
    its {name: tensor}; `opt_state` is not read."""
    strategy = cfg.train_parallelism
    pspecs = shardlib.param_specs(cfg, params, mesh, fsdp=fsdp,
                                  strategy=strategy)
    ospecs = pspecs if strategy == "dp" or not zero1 else \
        shardlib.zero1_specs(cfg, params, mesh, fsdp=fsdp)

    def to_shard(specs):
        return {n: shardlib.Sharding(mesh, s) for n, s in specs.items()}
    p_shard = to_shard(pspecs)
    opt_shard = adamw.AdamWState(step=shardlib.Sharding(mesh, ()),
                                 mu=to_shard(ospecs), nu=to_shard(ospecs))
    bspec = shardlib.Sharding(mesh, shardlib.batch_spec(
        mesh, batch_ndim - 1, batch=batch_size,
        axes="all" if strategy == "dp" else "data"))
    batch_shard = {"tokens": bspec, "labels": bspec}
    return (p_shard, opt_shard, batch_shard), (p_shard, opt_shard, None)


def input_specs_train(cfg, shape):
    """{"tokens", "labels"}: one global batch, (B, S) int32 or (B, S, K)
    with K codebooks, on meta."""
    b, s = shape.global_batch, shape.seq_len
    tok = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return {k: torch.empty(tok, dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}
