"""Wrapper of the flash attention kernel: the CUDA kernel
``csrc/flash_attention.cu`` for CUDA tensors, the plain version
(`ref.attention_ref`) for CPU ones.

Tensors are in the model stack's (B, S, H, dh) layout, as in the JAX
package's ``kernels/flash_attention/ops.py``.

>>> import torch
>>> q = torch.zeros(1, 3, 2, 64)
>>> v = torch.arange(3.0).reshape(1, 3, 1, 1).expand(1, 3, 1, 64)
>>> flash_attention(q, q[:, :, :1], v.contiguous())[0, :, :, 0].tolist()
[[0.0, 0.0], [0.5, 0.5], [1.0, 1.0]]
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (64, 128)
DTYPES = (torch.bfloat16, torch.float32)
_MAX_BATCH = 65_535        # the launch grid's z dimension

launches = _build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures bound once."""
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,S,H,dh) and k, v "
                         f"(B,S,KV,dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != dh or h % kv:
        raise ValueError(f"k and v must be (B,S,KV,dh) with H % KV == 0 "
                         f"for q {tuple(q.shape)}, got {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {dh}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= b <= _MAX_BATCH or s < 1:
        raise ValueError(f"need 1 <= B <= {_MAX_BATCH} and S >= 1, got "
                         f"B={b}, S={s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,dh); k/v: (B,S,KV,dh) -> (B,S,H,dh) in q's dtype:
    softmax(q·kᵀ/√dh)·v with float32 accumulation, query head h reading
    KV head h // (H/KV), and the mask q_pos >= k_pos if `causal`."""
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal).transpose(1, 2)
    if devices != {"cuda"} or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention runs on cpu or on one cuda "
                         f"device, got {q.device}, {k.device}, {v.device}")
    _check(q, k, v)
    b, s, h, dh = q.shape
    lib = _lib()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        status = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], dh, int(q.dtype == torch.bfloat16),
            int(causal), math.log2(math.e) / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, lib.flash_attention_error_string,
                 "flash_attention")
    launches.bump()
    return out
