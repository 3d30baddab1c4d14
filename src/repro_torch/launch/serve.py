"""Serving: batched proxy scoring (prefill) and decode steps, the JAX
package's ``launch/serve.py`` ``make_serve_prefill`` and
``make_serve_decode``.

`serve_prefill` maps a batch of records (token streams) to proxy scores
A(x) in [0,1], the SUPG pipeline's proxy plane; `serve_decode` advances one
token against KV/state caches (the decode_32k / long_500k shapes), which
it writes in place. `input_specs_prefill`, `input_specs_decode` and
`cache_specs_struct` give a shape's inputs and caches as ``meta`` tensors
(shapes and dtypes, nothing allocated); `shardings_for_serve` places the
parameters, inputs and caches on a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shardlib
from repro_torch.models import model as modellib


def _check(model, cfg) -> None:
    if model.cfg != cfg:
        raise ValueError(f"model built for {model.cfg.name}, server for "
                         f"{cfg.name}")


def make_serve_prefill(cfg, target_token=1):
    """A function ``serve_prefill(model, batch)`` -> (B,) float32 scores
    of ``batch["tokens"]`` (B,S) under a model built for `cfg`."""
    def serve_prefill(model, batch):
        _check(model, cfg)
        return modellib.proxy_scores(model, batch["tokens"], target_token)
    return serve_prefill


def make_serve_decode(cfg):
    """A function ``serve_decode(model, batch, caches)`` -> (logits (B,1,V)
    float32, caches) of one step: ``batch["tokens"]`` (B,1) at the rows'
    positions ``batch["pos"]`` (B,), under a model built for `cfg`, with
    `caches` from `model.init_caches` written in place."""
    def serve_decode(model, batch, caches):
        _check(model, cfg)
        return modellib.apply_decode(model, batch["tokens"], caches,
                                     batch["pos"])
    return serve_decode


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs_prefill(cfg, shape):
    """{"tokens"}: (B, S) int32, or (B, S, K) with K codebooks, on meta."""
    b, s = shape.global_batch, shape.seq_len
    tok = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return {"tokens": _meta(tok)}


def input_specs_decode(cfg, shape):
    """{"tokens": (B, 1) or (B, 1, K), "pos": (B,)}, int32 on meta."""
    b = shape.global_batch
    tok = (b, 1, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, 1)
    return {"tokens": _meta(tok), "pos": _meta((b,))}


def cache_specs_struct(cfg, shape, dtype=torch.bfloat16):
    """The decode caches of `shape` (`models.model.init_caches`) on meta."""
    return modellib.init_caches(cfg, shape.global_batch, shape.seq_len,
                                dtype, device="meta")


def shardings_for_serve(cfg, params, mesh, shape, kind, dtype=torch.bfloat16,
                        fsdp=False):
    """(in, out) `launch.sharding.Sharding`s of a serving step on `mesh`:
    for "prefill" ((params, {"tokens"}), None); for "decode" ((params,
    {"tokens", "pos"}, caches), (None, caches)), the batch over the data
    axes where it divides. `params` is the model or its {name: tensor}."""
    pspecs = shardlib.param_shardings(cfg, params, mesh, fsdp=fsdp)
    b = shape.global_batch
    extra = 2 if cfg.num_codebooks > 1 else 1
    bspec = shardlib.Sharding(mesh, shardlib.batch_spec(mesh, extra,
                                                         batch=b))
    if kind == "prefill":
        return (pspecs, {"tokens": bspec}), None
    cspecs = shardlib.cache_specs(cfg, cache_specs_struct(cfg, shape, dtype),
                                  mesh, b)
    c_shard = shardlib.map_leaves(lambda s: shardlib.Sharding(mesh, s),
                                  cspecs)
    batch = {"tokens": bspec,
             "pos": shardlib.Sharding(mesh, shardlib.batch_spec(
                 mesh, 0, batch=b))}
    return (pspecs, batch, c_shard), (None, c_shard)
