"""Wrapper of the linear scan kernels: on CUDA tensors, the chunked
tensor-core kernel ``csrc/linear_scan_chunked.cu`` for Mamba2's inputs and
the chunked kernel with a decay per channel ``csrc/linear_scan.cu`` for
every other input; the plain version (`ref.linear_scan_ref`) for CPU ones.

`route` picks the CUDA kernel from the inputs' structure before the launch:
``"chunked"`` where u is None (Mamba2's read after the update), w has dim
stride 0 (a scalar decay per step), dk and dv are at most 64, q, k are
bf16 or float32, v is float32, and where its row copies can read q, k and
v as they lie (dim stride 1, rows on 16-byte boundaries, dv a multiple of
4 and dk of 16 bytes); ``"channel"`` otherwise (RWKV6's bonus u, a decay
per state row, bf16 v, any strides). Neither falls back to the other: a
launch that fails raises. `launches` counts both kernels' launches,
`launches.routes` each route's.

`linear_scan` is differentiable: where autograd records it, its gradient
is `linear_scan_bwd`, the backward kernel ``csrc/linear_scan_bwd.cu`` on
CUDA tensors (one launch; `bwd_launches.routes` counts it by read,
``"mamba2"`` or ``"rwkv6"``) and `ref.linear_scan_bwd_ref` on CPU ones.
The final state carries no gradient: one that reaches it raises.

Tensors are in the JAX package's (B,H,S,d) layout (``kernels/linear_scan``).
The kernels read q, k, w and v through their strides, so broadcast views
cost nothing: Mamba2 passes its B and C, shared by all heads, as
``(B,S,N)[:, None].expand(B,H,S,N)`` and its scalar decay per head as
``(B,H,S)[..., None].expand(B,H,S,N)`` (stride 0 over the state dim), and
neither is materialized. o is allocated in v's memory layout and dtype. On
the card q and k share a dtype (bf16 or float32), v is bf16 or float32
(Mamba2's v = dt·x is float32 in either model dtype; an RWKV6 block hands
over its bf16 v, `models.rwkv.time_mix`) and w is float32. The backward
returns the gradients of such views at the views' shapes (dense), and
autograd's ``expand`` backward sums them.

>>> import torch
>>> one = torch.ones(1, 1, 3, 1)
>>> o, state = linear_scan(one, one, one, 0.5 * one)
>>> o.flatten().tolist(), state.flatten().tolist()
([1.0, 1.5, 1.75], [1.75])
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan import ref

MAX_DIM = 64               # dk and dv a block's state holds
DTYPES = (torch.bfloat16, torch.float32)

launches = _build.LaunchCounter(routes=("chunked", "channel"))
bwd_launches = _build.LaunchCounter(routes=("mamba2", "rwkv6"))
BWD_CHUNK = 64             # steps between the states the backward keeps
# Each route's library, ``csrc/<name>.cu``, the pointers its launch takes
# (q, k, v, w, o, state, and the channel kernel's u after w) and the ints
# after them (batch, heads, seq, dk, dv, qk_bf16, and the channel kernel's
# v_bf16), before (strides, stream).
LIBS = {"chunked": ("linear_scan_chunked", 6, 6),
        "channel": ("linear_scan", 7, 7)}


@functools.lru_cache(maxsize=None)
def _entry_points(which: str):
    """`which` route's (launch, error_string), bound once."""
    name, n_ptr, n_int = LIBS[which]
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return launch, err


def _rows_copyable(t: torch.Tensor) -> bool:
    """Whether 16-byte copies can read `t`'s rows as they lie: dim stride 1,
    the row's bytes and every other stride a multiple of 16 bytes, the
    data on a 16-byte boundary."""
    size = t.element_size()
    return (t.stride(-1) == 1 and (t.shape[-1] * size) % 16 == 0
            and t.data_ptr() % 16 == 0
            and all((st * size) % 16 == 0 for st in t.stride()[:-1]))


def route(q, k, v, w, u=None) -> str:
    """The CUDA kernel that `linear_scan` launches for these inputs:
    ``"chunked"`` for Mamba2's (see the module docstring), ``"channel"``
    otherwise. A function of shapes, dtypes and strides only, so it runs
    on CPU tensors too."""
    mamba2 = (u is None and w.stride(-1) == 0 and q.dtype in DTYPES
              and k.dtype == q.dtype and v.dtype == torch.float32
              and q.shape[-1] <= MAX_DIM and v.shape[-1] <= MAX_DIM)
    if mamba2 and all(_rows_copyable(t) for t in (q, k, v)):
        return "chunked"
    return "channel"


def _check(q, k, v, w, u) -> None:
    """Raise on what the CUDA kernel does not take."""
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError(f"linear_scan takes q, k, w (B,H,S,dk) and v "
                         f"(B,H,S,dv), got {tuple(q.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or w.shape != q.shape or v.shape[:3] != (b, h, s):
        raise ValueError(f"q, k, w must share a shape (B,H,S,dk) and v be "
                         f"(B,H,S,dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(w.shape)}, "
                         f"{tuple(v.shape)}")
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM) or min(b, h, s) < 1:
        raise ValueError(f"need 1 <= dk, dv <= {MAX_DIM} and B, H, S >= 1, "
                         f"got {tuple(q.shape)}, dv={dv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype:
        raise ValueError(f"q and k must share a dtype of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}")
    if v.dtype not in DTYPES:
        raise ValueError(f"v must be one of {DTYPES}, got {v.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"w must be float32, got {w.dtype}")
    if u is not None and u.shape != (h, dk):
        raise ValueError(f"u must be (H,dk) = {(h, dk)}, got "
                         f"{tuple(u.shape)}")


def _on_card(what: str, *tensors) -> bool:
    """False where every tensor lies on the CPU, True where all lie on one
    CUDA device; raises otherwise."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return False
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} runs on cpu or on one cuda device, "
                         f"got {[str(t.device) for t in tensors]}")
    return True


def _forward(q, k, v, w, u):
    """(o, final state) of the forward kernel its route picks, or of the
    plain version on CPU tensors."""
    tensors = (q, k, v, w) + (() if u is None else (u,))
    if not _on_card("linear_scan", *tensors):
        return ref.linear_scan_ref(q, k, v, w, u)
    _check(q, k, v, w, u)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    which = route(q, k, v, w, u)
    launch, error_string = _entry_points(which)
    with torch.cuda.device(q.device):
        o = torch.empty_like(v)            # v's layout when v is dense
        state = torch.empty(b, h, dk, dv, dtype=torch.float32,
                            device=q.device)
        uf = None if u is None else u.float().contiguous()
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr()]
        flags = [int(q.dtype == torch.bfloat16)]
        if which == "channel":
            ptrs.append(None if uf is None else uf.data_ptr())
            flags.append(int(v.dtype == torch.bfloat16))
        strides = (ctypes.c_longlong * 20)(
            *(x for t in (q, k, v, w, o) for x in t.stride()))
        status = launch(
            *ptrs, o.data_ptr(), state.data_ptr(), b, h, s, dk, dv, *flags,
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, error_string, LIBS[which][0])
    launches.bump(which)
    return o, state


@functools.lru_cache(maxsize=None)
def _bwd_entry_points():
    """The backward kernel's (launch, error_string), bound once."""
    lib = _build.load("linear_scan_bwd")
    launch = lib.linear_scan_bwd_launch
    launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    err = lib.linear_scan_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return launch, err


def linear_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor | None,
                    do: torch.Tensor):
    """The gradient of `linear_scan`'s o, given dL/do (B,H,S,dv) in v's
    dtype, with no gradient into the final state: (dq, dk, dv, dw, du),
    dense, at the inputs' shapes and in their dtypes (du None where u is).
    On CUDA tensors the backward kernel (one launch, counted by read in
    `bwd_launches`); on CPU ones `ref.linear_scan_bwd_ref`."""
    tensors = (q, k, v, w, do) + (() if u is None else (u,))
    if not _on_card("linear_scan_bwd", *tensors):
        return ref.linear_scan_bwd_ref(q, k, v, w, u, do)
    _check(q, k, v, w, u)
    if do.shape != v.shape or do.dtype != v.dtype:
        raise ValueError(f"do must be v's shape and dtype "
                         f"{tuple(v.shape)} {v.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    n_chunks = -(-s // BWD_CHUNK)
    launch, error_string = _bwd_entry_points()
    with torch.cuda.device(q.device):
        gq, gk, gv = (torch.empty(t.shape, dtype=t.dtype, device=q.device)
                      for t in (q, k, v))
        gw = torch.empty(w.shape, dtype=torch.float32, device=q.device)
        gu = None if u is None else torch.empty(b, h, dk,
                                                dtype=torch.float32,
                                                device=q.device)
        uf = None if u is None else u.float().contiguous()
        # the state before every BWD_CHUNK steps, each in the kernel's own
        # order of its 4096 floats
        kept = torch.empty(b * h * n_chunks * MAX_DIM * MAX_DIM,
                           dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 20)(
            *(x for t in (q, k, v, w, do) for x in t.stride()))
        status = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            None if uf is None else uf.data_ptr(), do.data_ptr(),
            gq.data_ptr(), gk.data_ptr(), gv.data_ptr(), gw.data_ptr(),
            None if gu is None else gu.data_ptr(), kept.data_ptr(),
            b, h, s, dk, dv, n_chunks, int(q.dtype == torch.bfloat16),
            int(v.dtype == torch.bfloat16), ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, error_string, "linear_scan_bwd")
    bwd_launches.bump("mamba2" if u is None else "rwkv6")
    if gu is not None:
        gu = gu.sum(0).to(u.dtype)          # over the batch, in one order
    return gq, gk, gv, gw, gu


class _LinearScan(torch.autograd.Function):
    """The scan with `linear_scan_bwd` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, w, u):
        """(o, final state) of `_forward`; the inputs kept where one needs
        a gradient."""
        ctx.set_materialize_grads(False)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v, w, u)
        return _forward(q, k, v, w, u)

    @staticmethod
    def backward(ctx, do, dstate):
        """dq, dk, dv, dw, du by `linear_scan_bwd`; raises where a
        gradient reaches the final state."""
        if dstate is not None:
            raise RuntimeError(
                "linear_scan: a gradient reached the final state, which "
                "carries none (the backward starts from dL/dS_T = 0)")
        if do is None:
            return None, None, None, None, None
        q, k, v, w, u = ctx.saved_tensors
        return linear_scan_bwd(q, k, v, w, u, do.to(v.dtype))


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor | None = None):
    """q, k, w: (B,H,S,dk); v: (B,H,S,dv); u: (H,dk) or None ->
    (o (B,H,S,dv) in v's dtype, final state (B,H,dk,dv) float32): the
    exact recurrence S_t = diag(w_t) S_{t-1} + k_tᵀ v_t from a zero state,
    on w clipped to [1e-6, 1], read after the update (u None, Mamba2) or
    before it with the bonus u (RWKV6). Differentiable in q, k, v, w and u
    through o (see `linear_scan_bwd`); the final state carries no
    gradient."""
    return _LinearScan.apply(q, k, v, w, u)
