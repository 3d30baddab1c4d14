"""Wrapper of the fused score sketch: the CUDA kernel ``csrc/score_hist.cu``
for a CUDA tensor, the plain version (`ref.score_hist_ref`) for a CPU one.

>>> import torch
>>> counts, sum_w, sum_a = score_hist(torch.tensor([0.0, 0.5, -1.0]), 4)
>>> counts.tolist(), sum_a.tolist()
([1.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.5, 0.0])
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.score_hist import ref

# Shared memory a CTA may use on Hopper, at kBinBytes = 20 bytes a bin
# (csrc/score_hist.cu: an int32 count and two uint64 fixed-point sums).
MAX_BINS = 232_448 // 20
_THREADS = 512

launches = _build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures bound once."""
    lib = _build.load("score_hist")
    lib.score_hist_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.score_hist_launch.restype = ctypes.c_int
    lib.score_hist_error_string.argtypes = [ctypes.c_int]
    lib.score_hist_error_string.restype = ctypes.c_char_p
    return lib


def score_hist(scores: torch.Tensor, num_bins: int = 4096) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, sum_w, sum_a), each (num_bins,) float32 on the scores'
    device. Per bin b = min(floor(clip(A,0,1)*B), B-1) over records with
    A >= 0: the record count, Σ sqrt(A) and Σ A."""
    if scores.device.type == "cpu":
        return ref.score_hist_ref(scores, num_bins)
    if scores.device.type != "cuda":
        raise ValueError(f"score_hist runs on cpu or cuda, not "
                         f"{scores.device}")
    if scores.dtype != torch.float32 or scores.dim() != 1 \
            or not scores.is_contiguous():
        raise ValueError("score_hist takes a contiguous 1-D float32 tensor, "
                         f"got {scores.dtype} of shape {tuple(scores.shape)}")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins must lie in [1, {MAX_BINS}] (20 bytes of "
                         f"shared memory a bin), got {num_bins}")
    dev = scores.device
    n = scores.numel()
    if n == 0:
        z = torch.zeros(num_bins, dtype=torch.float32, device=dev)
        return z, z.clone(), z.clone()
    lib = _lib()
    with torch.cuda.device(dev):
        scratch = torch.empty(3 * num_bins, dtype=torch.int64, device=dev)
        out = torch.empty((3, num_bins), dtype=torch.float32, device=dev)
        per_sm = max(1, min(4, MAX_BINS // num_bins))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(sms * per_sm, -(-n // (_THREADS * 4))))
        status = lib.score_hist_launch(
            scores.data_ptr(), n, num_bins, scratch.data_ptr(),
            out.data_ptr(), grid, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, lib.score_hist_error_string, "score_hist")
    launches.bump()
    return out[0], out[1], out[2]
