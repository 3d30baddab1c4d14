"""Gradient compression for a cross-pod all-reduce: int8 quantization with
error feedback (the JAX package's ``optim/grad_compress.py``), on tensors
and `torch.distributed`.

Where the link between pods is the thin pipe, a hierarchical all-reduce
reduces in full precision inside the pod and in int8 across pods, with
error-feedback residuals so the quantization noise does not accumulate in
the optimizer (Karimireddy et al. 2019):

    g_pod   = all_reduce(g, in-pod group)          float32
    q, res  = quantize_int8(g_pod + residual)
    g_all   = all_reduce(dequant(q), cross-pod group)

The reference runs it inside ``shard_map`` over named mesh axes; here the
axes are two process groups that the caller makes, as
`core.distributed` takes its group. Trees are dicts of tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization: (q int8, scale float32,
    residual x - q·scale float32)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    residual = xf - q.float() * scale
    return q, scale, residual


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q·scale in float32."""
    return q.float() * scale


def _zeros_like(tree: dict) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in tree.items()}


def compress_tree(grads: dict, residuals: dict = None):
    """Quantize every tensor of `grads` with error feedback: ({name: (q,
    scale)}, {name: new residual})."""
    if residuals is None:
        residuals = _zeros_like(grads)
    qs = {k: quantize_int8(g.float() + residuals[k]) for k, g in grads.items()}
    return ({k: (q, s) for k, (q, s, _) in qs.items()},
            {k: r for k, (_, _, r) in qs.items()})


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def hierarchical_psum(grads: dict, *, in_pod_group=None,
                      cross_pod_group=None, compress: bool = True,
                      residuals: dict = None):
    """A float32 all-reduce over `in_pod_group`, then one over
    `cross_pod_group` of each tensor int8-quantized with error feedback
    (its dequantized values are summed, as the reference's psum of
    q·scale). Returns (reduced grads, new residuals). With
    ``compress=False`` both hops are plain float32 all-reduces and the
    residuals come back as given."""
    g_pod = {k: _all_reduce(g.float().clone(), in_pod_group)
             for k, g in grads.items()}
    if not compress:
        return {k: _all_reduce(g, cross_pod_group)
                for k, g in g_pod.items()}, residuals
    if residuals is None:
        residuals = _zeros_like(g_pod)
    out, new_res = {}, {}
    for k, g in g_pod.items():
        q, scale, new_res[k] = quantize_int8(g + residuals[k])
        out[k] = _all_reduce(dequantize_int8(q, scale), cross_pod_group)
    return out, new_res
