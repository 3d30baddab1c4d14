"""Wrapper of the flash attention kernels: the CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(its gradient, at (dh, dv) = (64, 64)) for CUDA tensors, the plain
versions (`ref.attention_ref`, `ref.attention_bwd_ref`) for CPU ones.
`flash_attention` is a `torch.autograd.Function`: its backward is the
backward kernel on the card and the plain backward on the CPU.

Where a gradient is wanted the forward also keeps each row's logsumexp of
its scaled, masked scores, `lse` (B, H, S) float32 in natural units
(`flash_attention_fwd`): the backward takes P = exp(q·kᵀ/√dh − lse) from
it. On the card the kernels keep it in a (B, H, `lse_rows(S)`) buffer, S
rounded up to the 128-row tile, and `lse` is a view of its first S
columns.

Tensors are in the model stack's (B, S, H, dh) layout, as in the JAX
package's ``kernels/flash_attention/ops.py``. v may have a head dim dv of
its own (MLA's prefill: q·k at 192, v at 128), as the reference's
``chunked_causal_attention`` allows; o then has dv.

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
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

# (q·k head dim, v head dim) pairs the CUDA kernels take: the forward's,
# and the backward's
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
BWD_HEAD_DIMS = ((64, 64),)
DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID = 65_535         # the launch grids' y and z dimensions

launches = _build.LaunchCounter()
bwd_launches = _build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures bound once."""
    lib = _build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    geom = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_bf16_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, geom, geom, geom, i32, i32, i32,
        ctypes.c_float, i32, ptr, i32, ptr]
    lib.flash_attention_f32_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ptr]
    for fn in (lib.flash_attention_bf16_launch,
               lib.flash_attention_f32_launch):
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


# The bf16 kernel's tiles (csrc/flash_attention.cu): one persistent CTA an
# SM, with a producer and two consumer warpgroups, takes work tiles of
# TILE_Q query rows of one head from a counter and streams k and v in tiles
# of TILE_K keys through a ring of STAGES[head_dim] stages; every tile lies
# in shared memory as 64-column blocks of 128-byte rows: q and k tiles
# head_dim/64 of them, v tiles v_dim/64.
TILE_Q = TILE_K = 128
STAGES = {64: 4, 128: 3, 192: 2}
Q_STAGES = {64: 2, 128: 1, 192: 1}
BF16_THREADS = 384
_MAX_WORK = 2 ** 31 - 1


def tensor_map_geometry(t: torch.Tensor) -> Tuple[int, ...]:
    """The TMA tensor map of a (B, S, heads, d) bf16 tensor, from its
    strides: dims (d, heads, S, B) innermost first, then the byte strides
    of dims heads, S and B. TMA needs d contiguous and each stride a
    multiple of 16 bytes."""
    b, s, h, dh = t.shape
    size = t.element_size()
    return (dh, h, s, b, t.stride(2) * size, t.stride(1) * size,
            t.stride(0) * size)


def bf16_smem_bytes(head_dim: int, v_dim: int) -> int:
    """Dynamic shared memory of the bf16 kernel at (`head_dim`, `v_dim`):
    its q buffers and the ring's k and v tiles, 2 bytes an element, plus
    1024 bytes to align the base to the 128-byte swizzle's 1024-byte
    pattern."""
    return 2 * (Q_STAGES[head_dim] * TILE_Q * head_dim
                + STAGES[head_dim] * TILE_K * (head_dim + v_dim)) + 1024


def bf16_launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sms: int) -> dict:
    """The bf16 kernel's launch on a card of `sms` SMs: its work tiles
    (query tiles x heads x batch), one persistent CTA an SM up to that
    many, their threads and dynamic shared memory, and the tensor maps of
    q, k and v (o is laid out as q, with v's head dim)."""
    b, s, h, dh = q.shape
    work = -(-s // TILE_Q) * h * b
    return {"work": work, "ctas": min(work, sms), "threads": BF16_THREADS,
            "smem_bytes": bf16_smem_bytes(dh, v.shape[3]),
            "q_geom": tensor_map_geometry(q),
            "k_geom": tensor_map_geometry(k),
            "v_geom": tensor_map_geometry(v)}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention takes q (B,S,H,dh), k (B,S,KV,dh)"
                         f" and v (B,S,KV,dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != dh or h % kv:
        raise ValueError(f"k and v must be (B,S,KV,dh) with H % KV == 0 "
                         f"for q {tuple(q.shape)}, got {tuple(k.shape)}")
    if (dh, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"(head_dim, v_dim) must be one of {HEAD_DIMS}, "
                         f"got {(dh, v.shape[3])}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if -(-s // TILE_Q) * h * b > _MAX_WORK:
        raise ValueError(f"more than {_MAX_WORK} work tiles of {TILE_Q} "
                         f"query rows: B={b}, S={s}, H={h}")
    if not 1 <= b <= _MAX_GRID or s < 1:
        raise ValueError(f"need 1 <= B <= {_MAX_GRID} and S >= 1, got "
                         f"B={b}, S={s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _work_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The bf16 kernel's work-tile counter for launches on `stream`: two
    ints, zero before each launch (set once here; each launch's last CTA
    sets them back), one pair a stream so launches that may overlap do
    not share one."""
    key = (device.index, stream)
    counter = _counters.get(key)
    if counter is None:
        counter = _counters.setdefault(
            key, torch.zeros(2, dtype=torch.int32, device=device))
    return counter


def _on_card(*tensors) -> bool:
    """True for tensors on one CUDA device, False for CPU tensors; raises
    on a mix."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return False
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"flash_attention runs on cpu or on one cuda "
                         f"device, got {[str(t.device) for t in tensors]}")
    return True


def _heads_first(*tensors):
    """(B,S,heads,d) views as (B,heads,S,d)."""
    return [t.transpose(1, 2) for t in tensors]


def lse_rows(s: int) -> int:
    """Columns of the kernels' (B, H, ·) logsumexp and D buffers: S rounded
    up to the bf16 kernels' 128-row tiles, so each tile's rows are written
    and read whole."""
    return -(-s // TILE_Q) * TILE_Q


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, with_lse: bool = False):
    """The forward kernel on CUDA tensors, the plain version on CPU ones:
    o, or (o, lse) with `with_lse`."""
    if not _on_card(q, k, v):
        out = ref.attention_ref(*_heads_first(q, k, v), causal,
                                return_lse=with_lse)
        if with_lse:
            return out[0].transpose(1, 2), out[1]
        return out.transpose(1, 2)
    _check(q, k, v)
    b, s, h, dh = q.shape
    dv = v.shape[3]
    lib = _lib()
    scale_log2 = math.log2(math.e) / math.sqrt(dh)
    with torch.cuda.device(q.device):
        out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
        lse = (torch.empty((b, h, lse_rows(s)), dtype=torch.float32,
                           device=q.device) if with_lse else None)
        lse_ptr = lse.data_ptr() if with_lse else None
        stride = lse_rows(s)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            plan = bf16_launch_plan(q, k, v, _sm_count(q.device.index))
            geoms = [(ctypes.c_longlong * 7)(*plan[name])
                     for name in ("q_geom", "k_geom", "v_geom")]
            status = lib.flash_attention_bf16_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, stride, *geoms, dh, dv, int(causal), scale_log2,
                plan["ctas"], _work_counter(q.device, stream).data_ptr(),
                plan["smem_bytes"], stream)
        else:
            status = lib.flash_attention_f32_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, stride, b, s, h, k.shape[2], dh, dv, int(causal),
                scale_log2, stream)
    _build.check(status, lib.flash_attention_error_string,
                 "flash_attention")
    launches.bump()
    return (out, lse[:, :, :s]) if with_lse else out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True):
    """(o, lse): `flash_attention`'s output and each row's logsumexp of
    its scaled, masked scores, (B, H, S) float32 in natural units (on the
    card a view of the kernel's (B, H, `lse_rows(S)`) buffer). One launch
    of the forward kernel on CUDA tensors; not differentiable."""
    return _forward(q, k, v, causal, with_lse=True)


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The built backward kernel library, its C signature bound once."""
    lib = _build.load("flash_attention_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    geom = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_bwd_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, geom, geom, i32,
        i32, i32, i32, i32, i32, i32, ctypes.c_float, ctypes.c_float, i32,
        i32, ptr, ptr]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_backward(head_dim: int, v_dim: int) -> None:
    """Raise ValueError unless the backward kernel takes (`head_dim`,
    `v_dim`)."""
    if (head_dim, v_dim) not in BWD_HEAD_DIMS:
        raise ValueError(
            f"the flash_attention backward kernel takes (head_dim, v_dim) "
            f"in {BWD_HEAD_DIMS}, got {(head_dim, v_dim)}: the other pairs "
            f"are queued in ROADMAP.md")


# The bf16 backward's two persistent launches (csrc/flash_attention_bwd.cu):
# dq over work tiles of BWD_DQ_ROWS query rows of one head, dk and dv over
# work tiles of BWD_DKDV_KEYS keys of one KV head; each one CTA an SM up to
# its work, with the forward's 384 threads.
BWD_DQ_ROWS = 128
BWD_DKDV_KEYS = 128


def bwd_launch_plan(q: torch.Tensor, k: torch.Tensor, sms: int) -> dict:
    """The bf16 backward's launches on a card of `sms` SMs: each kernel's
    work tiles and persistent CTAs, the columns of its lse and D buffers,
    and the tensor maps of q (and dO, laid out as q) and of k (and v)."""
    b, s, h, _ = q.shape
    dq_work = -(-s // BWD_DQ_ROWS) * h * b
    dkdv_work = -(-s // BWD_DKDV_KEYS) * k.shape[2] * b
    return {"dq_work": dq_work, "dq_ctas": min(dq_work, sms),
            "dkdv_work": dkdv_work, "dkdv_ctas": min(dkdv_work, sms),
            "threads": BF16_THREADS, "s_pad": lse_rows(s),
            "q_geom": tensor_map_geometry(q),
            "k_geom": tensor_map_geometry(k)}


def _check_lse(lse, b: int, h: int, s: int, device) -> None:
    """Raise unless `lse` is what the backward kernel reads: a float32
    (B, H, S) tensor on `device` whose rows lie `lse_rows(S)` apart from a
    16-byte aligned start, as `flash_attention_fwd` returns it."""
    pad = lse_rows(s)
    if lse is None or tuple(lse.shape) != (b, h, s) \
            or lse.dtype != torch.float32 or lse.device != device \
            or lse.stride() != (h * pad, pad, 1) or lse.data_ptr() % 16:
        got = None if lse is None else (tuple(lse.shape), lse.dtype,
                                        lse.stride())
        raise ValueError(
            f"flash_attention_bwd on the card needs the forward's lse "
            f"(flash_attention_fwd): a float32 (B, H, S) = {(b, h, s)} "
            f"tensor on {device} with rows {pad} apart, got {got}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, lse=None):
    """The gradient of `flash_attention`: (dq, dk, dv) in the inputs'
    dtype, given its output o (B,S,H,dv), its rows' logsumexp `lse`
    (B,H,S) from `flash_attention_fwd`, and dL/do. The backward kernel on
    CUDA tensors ((dh, dv) = (64, 64); bf16: two launches on one stream,
    float32: three; counted once), where a missing or mis-shaped lse
    raises; `ref.attention_bwd_ref` on CPU ones (with `lse` if given)."""
    if not _on_card(q, k, v, o, do):
        dq, dk, dv = ref.attention_bwd_ref(*_heads_first(q, k, v, o, do),
                                           causal, lse=lse)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    _check(q, k, v)
    b, s, h, dh = q.shape
    check_backward(dh, v.shape[3])
    do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        if t.shape != (b, s, h, v.shape[3]) or t.dtype != q.dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{q.dtype} (B,S,H,dv), got {tuple(t.shape)} "
                             f"{t.dtype}")
    _check_lse(lse, b, h, s, q.device)
    lib = _bwd_lib()
    plan = bwd_launch_plan(q, k, _sm_count(q.device.index))
    geoms = [(ctypes.c_longlong * 7)(*plan[name])
             for name in ("q_geom", "k_geom")]
    with torch.cuda.device(q.device):
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((b, h, plan["s_pad"]), dtype=torch.float32,
                            device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), *geoms, b, s, h, k.shape[2],
            plan["s_pad"], int(causal), int(q.dtype == torch.bfloat16),
            math.log2(math.e) / math.sqrt(dh), 1.0 / math.sqrt(dh),
            plan["dq_ctas"], plan["dkdv_ctas"],
            _work_counter(q.device, stream).data_ptr(), stream)
    _build.check(status, lib.flash_attention_bwd_error_string,
                 "flash_attention_bwd")
    bwd_launches.bump()
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        """o of the forward kernel (or its plain version); where an input
        needs a gradient, its lse too, kept with q, k, v and o for the
        backward."""
        if any(ctx.needs_input_grad[:3]):
            o, lse = _forward(q, k, v, causal, with_lse=True)
        else:
            o, lse = _forward(q, k, v, causal), None
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        """dq, dk, dv by `flash_attention_bwd` from the forward's lse."""
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                     lse=lse), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,dh); k: (B,S,KV,dh); v: (B,S,KV,dv) -> (B,S,H,dv) in q's
    dtype: softmax(q·kᵀ/√dh)·v with float32 accumulation, query head h
    reading KV head h // (H/KV), and the mask q_pos >= k_pos if `causal`.
    Differentiable: where autograd records it, its gradient is
    `flash_attention_bwd`."""
    return _FlashAttention.apply(q, k, v, causal)
