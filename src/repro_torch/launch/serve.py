"""Serving: batched proxy scoring (prefill), the JAX package's
``launch/serve.py`` ``make_serve_prefill``.

`serve_prefill` maps a batch of records (token streams) to proxy scores
A(x) in [0,1], the SUPG pipeline's proxy plane. Decode, input specs and
shardings wait for their slices (ROADMAP §1).
"""
from __future__ import annotations

from repro_torch.models import model as modellib


def make_serve_prefill(cfg, target_token=1):
    """A function ``serve_prefill(model, batch)`` -> (B,) float32 scores
    of ``batch["tokens"]`` (B,S) under a model built for `cfg`."""
    def serve_prefill(model, batch):
        if model.cfg != cfg:
            raise ValueError(f"model built for {model.cfg.name}, server for "
                             f"{cfg.name}")
        return modellib.proxy_scores(model, batch["tokens"], target_token)
    return serve_prefill
