"""Wrapper of the fused threshold selection: the CUDA kernel
``csrc/threshold_select.cu`` for a CUDA tensor, the plain version
(`ref.threshold_select_ref`) for a CPU one.

>>> import torch
>>> threshold_select(torch.tensor([-1.0, 0.2, 0.7, 0.9]), 0.5).tolist()
[2, 3]
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.threshold_select import ref

launches = _build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> Tuple[ctypes.CDLL, int]:
    """The built kernel library, its C signatures bound once, and its
    tile (records a CTA of either pass takes)."""
    lib = _build.load("threshold_select")
    for fn in (lib.threshold_select_count, lib.threshold_select_scatter):
        fn.restype = ctypes.c_int
    lib.threshold_select_count.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.threshold_select_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.threshold_select_tile.restype = ctypes.c_int
    lib.threshold_select_error_string.argtypes = [ctypes.c_int]
    lib.threshold_select_error_string.restype = ctypes.c_char_p
    return lib, lib.threshold_select_tile()


def threshold_select(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """Ascending int64 indices, on the scores' device, of
    {i : scores[i] >= max(tau, 0)} compared in float32: the -1 unscored
    sentinel is never selected. Reads the selected count back once."""
    if scores.device.type == "cpu":
        return ref.threshold_select_ref(scores, tau)
    if scores.device.type != "cuda":
        raise ValueError(f"threshold_select runs on cpu or cuda, not "
                         f"{scores.device}")
    if scores.dtype != torch.float32 or scores.dim() != 1 \
            or not scores.is_contiguous():
        raise ValueError("threshold_select takes a contiguous 1-D float32 "
                         f"tensor, got {scores.dtype} of shape "
                         f"{tuple(scores.shape)}")
    dev = scores.device
    n = scores.numel()
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    lib, tile = _lib()
    thr = ref.threshold32(tau)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tiles = -(-n // tile)
        counts = torch.empty(tiles, dtype=torch.int64, device=dev)
        status = lib.threshold_select_count(scores.data_ptr(), n, thr,
                                            counts.data_ptr(), stream)
        _build.check(status, lib.threshold_select_error_string,
                     "threshold_select count")
        ends = torch.cumsum(counts, 0)
        total = int(ends[-1])
        out = torch.empty(total, dtype=torch.int64, device=dev)
        if total:
            offsets = ends - counts
            status = lib.threshold_select_scatter(
                scores.data_ptr(), n, thr, offsets.data_ptr(),
                out.data_ptr(), stream)
            _build.check(status, lib.threshold_select_error_string,
                         "threshold_select scatter")
    launches.bump()
    return out
