"""Wrapper of the build's per-chunk pass: the CUDA kernel
``csrc/score_hist.cu`` for a CUDA tensor, the plain versions
(`ref.score_hist_ref`, `ref.chunk_masses_ref`) for a CPU one.

>>> import torch
>>> counts, sum_w, sum_a = score_hist(torch.tensor([0.0, 0.5, -1.0]), 4)
>>> counts.tolist(), sum_a.tolist()
([1.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.5, 0.0])
>>> masses = torch.empty(2, dtype=torch.float64)
>>> _ = score_hist(torch.tensor([0.25, 4.0, -1.0]), 4, masses=masses)
>>> masses.tolist()
[1.5, 1.25]
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.score_hist import ref

# Shared memory a CTA may use on Hopper, less the kernel's 1 KiB of
# reductions, at 20 bytes a bin (csrc/score_hist.cu: kReserved, kBinBytes:
# five uint32 words, a count and two fixed-point sums as low/high words),
# the bins padded to a multiple of 32 (`padded_bins`).
MAX_BINS = (232_448 - 1024) // 20 // 32 * 32
# Records a launch takes at most (csrc/score_hist.cu: kMaxRecords).
MAX_RECORDS = 2 ** 31 - 1

launches = _build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures bound once."""
    lib = _build.load("score_hist")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.score_hist_launch.argtypes = [ptr, ctypes.c_longlong, i32, ptr, ptr,
                                      ptr, i32, ptr]
    lib.score_hist_launch.restype = i32
    lib.score_hist_init.restype = i32
    lib.score_hist_max_clusters.argtypes = [i32, ctypes.POINTER(i32)]
    lib.score_hist_max_clusters.restype = i32
    lib.score_hist_clusters.argtypes = [ctypes.c_longlong, i32]
    lib.score_hist_clusters.restype = i32
    lib.score_hist_scratch_words.argtypes = [i32]
    lib.score_hist_scratch_words.restype = ctypes.c_longlong
    lib.score_hist_error_string.argtypes = [i32]
    lib.score_hist_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _init(device_index: int) -> None:
    """Lets the kernel take its shared memory on a device: once a process."""
    lib = _lib()
    with torch.cuda.device(device_index):
        _build.check(lib.score_hist_init(), lib.score_hist_error_string,
                     "score_hist")


@functools.lru_cache(maxsize=None)
def _max_clusters(device_index: int, num_bins: int) -> int:
    """Clusters of the kernel the device runs at once at `num_bins`: read
    once."""
    lib = _lib()
    found = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(lib.score_hist_max_clusters(num_bins,
                                                 ctypes.byref(found)),
                     lib.score_hist_error_string, "score_hist")
    if found.value < 1:
        raise RuntimeError(f"score_hist: no cluster fits at {num_bins} bins")
    return found.value


_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
_scratch_lock = threading.Lock()


def _scratch_for(device: torch.device, stream: int,
                 words: int) -> torch.Tensor:
    """The scratch of launches on `stream` with at least `words` words:
    zero when made, and each launch leaves it zero. One a stream, so
    launches that may overlap do not share one."""
    key = (device.index, stream)
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < words:
            buf = _scratch[key] = torch.zeros(words, dtype=torch.int64,
                                              device=device)
        return buf


def score_hist(scores: torch.Tensor, num_bins: int = 4096,
               masses: Optional[torch.Tensor] = None) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, sum_w, sum_a), each (num_bins,) float32 on the scores'
    device. Per bin b = min(floor(clip(A,0,1)*B), B-1) over records with
    A >= 0: the record count, Σ sqrt(A) and Σ A.

    Given `masses`, a contiguous (2,) float64 tensor on the scores'
    device, also writes the float64 Σ sqrt(clip(A)) and Σ clip(A) there
    (`ref.chunk_masses_ref`). On the card one launch computes both, with
    no host sync."""
    if masses is not None and (
            masses.dtype != torch.float64 or tuple(masses.shape) != (2,)
            or not masses.is_contiguous() or masses.device != scores.device):
        raise ValueError("masses must be a contiguous (2,) float64 tensor on "
                         f"{scores.device}, got {masses.dtype} of shape "
                         f"{tuple(masses.shape)} on {masses.device}")
    if scores.device.type == "cpu":
        if masses is not None:
            masses.copy_(ref.chunk_masses_ref(scores))
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
    n = scores.numel()
    if n > MAX_RECORDS:
        raise ValueError(f"score_hist takes at most {MAX_RECORDS} records a "
                         f"call, got {n}")
    dev = scores.device
    if n == 0:
        if masses is not None:
            masses.zero_()
        z = torch.zeros(num_bins, dtype=torch.float32, device=dev)
        return z, z.clone(), z.clone()
    lib = _lib()
    with torch.cuda.device(dev):
        _init(dev.index)
        clusters = lib.score_hist_clusters(
            n, _max_clusters(dev.index, num_bins))
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        scratch = _scratch_for(dev, stream,
                               lib.score_hist_scratch_words(num_bins))
        out = torch.empty((3, num_bins), dtype=torch.float32, device=dev)
        status = lib.score_hist_launch(
            scores.data_ptr(), n, num_bins, scratch.data_ptr(),
            out.data_ptr(), None if masses is None else masses.data_ptr(),
            clusters, stream)
    _build.check(status, lib.score_hist_error_string, "score_hist")
    launches.bump()
    return out[0], out[1], out[2]
