"""Serving: batched proxy scoring (prefill) and decode steps, the JAX
package's ``launch/serve.py`` ``make_serve_prefill`` and
``make_serve_decode``.

`serve_prefill` maps a batch of records (token streams) to proxy scores
A(x) in [0,1], the SUPG pipeline's proxy plane; `serve_decode` advances one
token against KV/state caches (the decode_32k / long_500k shapes), which
it writes in place. Input specs and shardings wait for their slices
(ROADMAP §1).
"""
from __future__ import annotations

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
