"""Wrapper of the fused threshold selection: the CUDA kernel
``csrc/threshold_select.cu`` for a CUDA tensor, the plain version
(`ref.threshold_select_ref`) for a CPU one. `select_at_least` and
`count_at_least` give {A >= tau} for any tau: the kernel's set plus, where
tau < 0, the records in [tau, 0) by a plain compare.

>>> import torch
>>> threshold_select(torch.tensor([-1.0, 0.2, 0.7, 0.9]), 0.5).tolist()
[2, 3]
>>> int(threshold_count(torch.tensor([-1.0, 0.2, 0.7, 0.9]), 0.5))
2
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.threshold_select import ref

launches = _build.LaunchCounter()
_host = threading.local()
_EPOCHS = 0xFFFF             # a status word's epoch is 16 bits, 0 unused


@functools.lru_cache(maxsize=None)
def _lib() -> Tuple[ctypes.CDLL, int]:
    """The built kernel library, its C signatures bound once, and its
    tile (records a CTA takes)."""
    lib = _build.load("threshold_select")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.threshold_select_launch.argtypes = [
        ptr, ctypes.c_longlong, ctypes.c_float, ptr, ptr, i32, ptr,
        ctypes.c_uint, i32, ptr]
    lib.threshold_select_launch.restype = ctypes.c_int
    lib.threshold_select_tile.restype = ctypes.c_int
    lib.threshold_select_error_string.argtypes = [ctypes.c_int]
    lib.threshold_select_error_string.restype = ctypes.c_char_p
    return lib, lib.threshold_select_tile()


def _check(scores: torch.Tensor) -> None:
    """Raise on what the CUDA kernel does not take."""
    if scores.device.type != "cuda":
        raise ValueError(f"threshold_select runs on cpu or cuda, not "
                         f"{scores.device}")
    if scores.dtype != torch.float32 or scores.dim() != 1 \
            or not scores.is_contiguous():
        raise ValueError("threshold_select takes a contiguous 1-D float32 "
                         f"tensor, got {scores.dtype} of shape "
                         f"{tuple(scores.shape)}")


def _host_total() -> torch.Tensor:
    """This thread's word of pinned host memory, which the kernel writes
    the selected count to: the call's one read-back needs no copy
    (`_host.view` reads it)."""
    total = getattr(_host, "total", None)
    if total is None:
        total = _host.total = torch.empty(1, dtype=torch.int64,
                                          pin_memory=True)
        _host.view = total.numpy()
    return total


class _Workspace:
    """A stream's selection workspace: the ticket counters and the tiles'
    status words (zero when made), and the epoch of its last launch."""

    def __init__(self, words: int, device: torch.device):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.epoch = 0


_workspaces: Dict[Tuple[int, int], _Workspace] = {}
_workspaces_lock = threading.Lock()


def _workspace(device: torch.device, stream: int,
               words: int) -> Tuple[torch.Tensor, int]:
    """The workspace of `stream` with at least `words` words, and the new
    epoch of a launch on it. Launches on one stream run in order and each
    takes its own epoch, so none reads another's status words as its own;
    a workspace is made anew (zero) when it is too small or its epochs run
    out."""
    key = (device.index, stream)
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None or ws.words.numel() < words or ws.epoch == _EPOCHS:
            old = 0 if ws is None else ws.words.numel()
            ws = _workspaces[key] = _Workspace(max(words, old), device)
        ws.epoch += 1
        return ws.words, ws.epoch


def _on(dev: torch.device):
    """`dev` as the current device (the launch's), entered only where it
    is not already."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch(scores: torch.Tensor, tau: float, count_only: bool,
            wait: bool = False) -> torch.Tensor:
    """One launch over a non-empty CUDA `scores`. Selecting, returns the
    indices at capacity n (their count goes to this thread's pinned host
    word); counting, a 0-d tensor that will hold the count. With `wait`,
    returns once the stream has run it."""
    dev = scores.device
    n = scores.numel()
    lib, tile = _lib()
    with _on(dev):
        # The current stream's handle, without building a Stream object
        # (a few microseconds a call at this kernel's size).
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if count_only:
            out = torch.empty(2, dtype=torch.int64, device=dev)
            ws, host, epoch = out.data_ptr(), None, 0
        else:
            out = torch.empty(n, dtype=torch.int64, device=dev)
            words, epoch = _workspace(dev, stream, 2 + -(-n // tile))
            ws, host = words.data_ptr(), _host_total().data_ptr()
        status = lib.threshold_select_launch(
            scores.data_ptr(), n, ref.threshold32(tau), out.data_ptr(), ws,
            int(count_only), host, epoch, int(wait), stream)
    _build.check(status, lib.threshold_select_error_string,
                 "threshold_select")
    launches.bump()
    return out[1] if count_only else out


def threshold_select(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """Ascending int64 indices, on the scores' device, of
    {i : scores[i] >= max(tau, 0)} compared in float32: the -1 unscored
    sentinel is never selected. On the card: one kernel launch, which also
    writes the selected count to pinned host memory, and one wait for it."""
    if scores.device.type == "cpu":
        return ref.threshold_select_ref(scores, tau)
    _check(scores)
    if scores.numel() == 0:
        return torch.empty(0, dtype=torch.int64, device=scores.device)
    out = _launch(scores, tau, count_only=False, wait=True)
    return out[:int(_host.view[0])]


def threshold_count(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """|{i : scores[i] >= max(tau, 0)}| in float32, as a 0-d int64 tensor
    on the scores' device; on the card one kernel launch and no sync."""
    if scores.device.type == "cpu":
        return ref.threshold_count_ref(scores, tau)
    _check(scores)
    if scores.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=scores.device)
    return _launch(scores, tau, count_only=True)


def _below_zero(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """Mask of {tau <= A < 0}: the records that `threshold_select` and
    `threshold_count` (which keep A >= max(tau, 0)) leave out where
    tau < 0."""
    return (scores < 0) & (scores >= tau)


def select_at_least(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """Ascending int64 indices of {A >= tau} on the scores' device: one
    `threshold_select` launch on the card, the records in [tau, 0) added
    by a plain compare where tau < 0."""
    idx = threshold_select(scores, tau)
    if tau < 0:
        below = torch.nonzero(_below_zero(scores, tau)).reshape(-1)
        if below.numel():
            idx = torch.sort(torch.cat([below, idx])).values
    return idx


def count_at_least(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """|{A >= tau}|, exact, as a 0-d int64 tensor on the scores' device:
    one `threshold_count` launch on the card (no host sync), plus the
    records in [tau, 0) where tau < 0."""
    count = threshold_count(scores, tau)
    if tau < 0:
        count = count + _below_zero(scores, tau).sum()
    return count
