"""Wrapper of the flash attention kernels: the CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(its gradient) for CUDA tensors, both at (dh, dv) = (64, 64), (128, 128)
and (192, 128), the plain versions (`ref.attention_ref`,
`ref.attention_bwd_ref`) for CPU ones.
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
``chunked_causal_attention`` allows; o then has dv. k and v may have Sk >=
S rows (context parallelism: one rank's query rows against the keys up to
its last row): query row i then sits at position Sk - S + i, and the
causal mask keeps the keys at or before it (bottom-right aligned, as
FlashAttention 2 aligns it). The bf16 kernel asks (Sk - S) % 128 == 0
when causal; the backward kernel takes Sk = S only.

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
BWD_HEAD_DIMS = HEAD_DIMS
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
        i32, ctypes.c_float, ptr]
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True) -> None:
    """Raise on what the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention takes q (B,S,H,dh), k (B,S,KV,dh)"
                         f" and v (B,S,KV,dv), k and v with any S >= 1 "
                         f"rows, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % kv or sk < 1:
        raise ValueError(f"k and v must be (B,S,KV,dh) with H % KV == 0 "
                         f"for q {tuple(q.shape)}, got {tuple(k.shape)}")
    if causal and (sk < s or (q.dtype == torch.bfloat16
                              and (sk - s) % TILE_K)):
        raise ValueError(f"causal attention takes Sk >= S keys (and, in "
                         f"bf16, Sk - S a multiple of {TILE_K}), got S={s}, "
                         f"Sk={sk}")
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
    _check(q, k, v, causal)
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
                lse_ptr, stride, b, s, k.shape[1], h, k.shape[2], dh, dv,
                int(causal),
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
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, geom, geom, geom,
        geom, i32, i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float,
        ctypes.c_float, i32, i32, i32, i32, i32, ptr, ptr]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_backward(head_dim: int, v_dim: int, s: int = 1,
                   s_k: int = 1) -> None:
    """Raise ValueError unless the backward kernel takes (`head_dim`,
    `v_dim`) with `s_k` keys for `s` queries (it takes Sk = S only)."""
    if (head_dim, v_dim) not in BWD_HEAD_DIMS:
        raise ValueError(
            f"the flash_attention backward kernel takes (head_dim, v_dim) "
            f"in {BWD_HEAD_DIMS}, the forward kernel's pairs, got "
            f"{(head_dim, v_dim)}")
    if s_k != s:
        raise ValueError(
            f"the flash_attention backward kernel takes as many keys as "
            f"queries, got S={s}, Sk={s_k}: the backward at Sk > S is "
            f"queued in ROADMAP.md")


# The bf16 backward's persistent launches (csrc/flash_attention_bwd.cu,
# `BwdLayout` and `KvLayout`), each one CTA an SM up to its work, with the
# forward's 384 threads. `dq_wgmma` takes work tiles of BWD_DQ_ROWS query
# rows of one head, streams k and v in stages of BWD_DQ_KEYS[head_dim]
# keys through a ring of BWD_DQ_STAGES stages and buffers q and dO
# BWD_DQ_QBUFS deep. `dkdv_wgmma` takes work tiles of BWD_DKDV_KEYS keys
# of one KV head and streams q, dO, lse and D through a ring: once for dk
# and dv at head dim 64, and at the wider pairs once for dv and once for
# dk (a consumer thread holds 168 registers), in stages of
# BWD_KV_ROWS[head_dim] = (dv's, dk's) query rows. Tiles are 64-column
# blocks of 128-byte rows, as the forward's.
BWD_DQ_ROWS = 128
BWD_DKDV_KEYS = 128
BWD_DQ_KEYS = {64: 64, 128: 64, 192: 32}
BWD_DQ_STAGES = {64: 4, 128: 3, 192: 6}
BWD_DQ_QBUFS = {64: 2, 128: 2, 192: 1}
BWD_KV_ROWS = {64: (64, 64), 128: (64, 64), 192: (64, 32)}
BWD_DKDV_LAUNCHES = {64: 1, 128: 2, 192: 2}
_SMEM = 232_448 - 128       # a CTA's dynamic shared memory beside its bars


def _kv_smem(head_dim: int, v_dim: int, rows: int, with_v: bool) -> int:
    """Dynamic shared memory of a `dkdv_wgmma` launch: k (and v) of 128
    keys and as many stages of `rows` rows of q and dO and `rows` floats
    of lse and D, each padded to 1024 bytes, as fit (4 at head dim 64),
    plus 1024 bytes of alignment."""
    ring = 2 * BWD_DKDV_KEYS * (head_dim + (v_dim if with_v else 0))
    stage = -(-(2 * rows * (head_dim + v_dim) + 2 * 4 * rows) // 1024) * 1024
    stages = 4 if head_dim == 64 else (_SMEM - 1024 - ring) // stage
    return ring + stages * stage + 1024


def bwd_smem_bytes(head_dim: int, v_dim: int) -> Tuple[int, int, int]:
    """Dynamic shared memory of the `dq_wgmma`, dv and dk launches at
    (`head_dim`, `v_dim`), 2 bytes an element (dv's and dk's are the one
    dk/dv launch's at head dim 64): dq's q and dO buffers and its ring of
    k and v stages, plus 1024 bytes to align the base to the swizzle's
    1024-byte pattern; `_kv_smem` for the others (the dv launch holds no
    v)."""
    width = head_dim + v_dim
    dq = 2 * (BWD_DQ_QBUFS[head_dim] * BWD_DQ_ROWS * width
              + BWD_DQ_STAGES[head_dim] * BWD_DQ_KEYS[head_dim] * width) \
        + 1024
    dv_rows, dk_rows = BWD_KV_ROWS[head_dim]
    both = head_dim == 64
    return (dq, _kv_smem(head_dim, v_dim, dv_rows, both),
            _kv_smem(head_dim, v_dim, dk_rows, True))


def bwd_launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sms: int) -> dict:
    """The bf16 backward's launches on a card of `sms` SMs: each kernel's
    work tiles and persistent CTAs, the dynamic shared memory of the dq,
    dv and dk launches, dq's keys and dv's and dk's query rows a stage,
    how many dk/dv launches (1, or 2 at the wider pairs), the columns of
    the lse and D buffers, and the tensor maps of q, k, v and dO
    (contiguous (B, S, H, dv), as the wrapper makes it)."""
    b, s, h, dh = q.shape
    dv = v.shape[3]
    dq_work = -(-s // BWD_DQ_ROWS) * h * b
    dkdv_work = -(-s // BWD_DKDV_KEYS) * k.shape[2] * b
    dq_smem, dv_smem, dk_smem = bwd_smem_bytes(dh, dv)
    return {"dq_work": dq_work, "dq_ctas": min(dq_work, sms),
            "dkdv_work": dkdv_work, "dkdv_ctas": min(dkdv_work, sms),
            "threads": BF16_THREADS, "s_pad": lse_rows(s),
            "dq_smem_bytes": dq_smem, "dv_smem_bytes": dv_smem,
            "dk_smem_bytes": dk_smem, "dq_keys": BWD_DQ_KEYS[dh],
            "kv_rows": BWD_KV_ROWS[dh],
            "dkdv_launches": BWD_DKDV_LAUNCHES[dh],
            "q_geom": tensor_map_geometry(q),
            "k_geom": tensor_map_geometry(k),
            "v_geom": tensor_map_geometry(v),
            "do_geom": (dv, h, s, b, 2 * dv, 2 * h * dv, 2 * s * h * dv)}


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
    CUDA tensors ((dh, dv) in `BWD_HEAD_DIMS` and Sk = S; bf16: two
    launches on one stream, three at the wider pairs; float32: three;
    counted once), where a missing or mis-shaped lse raises;
    `ref.attention_bwd_ref` on CPU ones (with `lse` if given, and any
    Sk)."""
    if not _on_card(q, k, v, o, do):
        dq, dk, dv = ref.attention_bwd_ref(*_heads_first(q, k, v, o, do),
                                           causal, lse=lse)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    _check(q, k, v, causal)
    b, s, h, dh = q.shape
    check_backward(dh, v.shape[3], s, k.shape[1])
    do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        if t.shape != (b, s, h, v.shape[3]) or t.dtype != q.dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{q.dtype} (B,S,H,dv), got {tuple(t.shape)} "
                             f"{t.dtype}")
    _check_lse(lse, b, h, s, q.device)
    lib = _bwd_lib()
    plan = bwd_launch_plan(q, k, v, _sm_count(q.device.index))
    geoms = [(ctypes.c_longlong * 7)(*plan[name])
             for name in ("q_geom", "k_geom", "v_geom", "do_geom")]
    with torch.cuda.device(q.device):
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((b, h, plan["s_pad"]), dtype=torch.float32,
                            device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), *geoms, b, s, h, k.shape[2],
            dh, v.shape[3], plan["s_pad"], int(causal),
            int(q.dtype == torch.bfloat16),
            math.log2(math.e) / math.sqrt(dh), 1.0 / math.sqrt(dh),
            plan["dq_ctas"], plan["dkdv_ctas"], plan["dq_smem_bytes"],
            plan["dv_smem_bytes"], plan["dk_smem_bytes"],
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
    """q: (B,S,H,dh); k: (B,Sk,KV,dh); v: (B,Sk,KV,dv) -> (B,S,H,dv) in
    q's dtype: softmax(q·kᵀ/√dh)·v with float32 accumulation, query head h
    reading KV head h // (H/KV), and the mask q_pos >= k_pos if `causal`,
    query row i at position Sk - S + i (Sk >= S when causal).
    Differentiable: where autograd records it, its gradient is
    `flash_attention_bwd`."""
    return _FlashAttention.apply(q, k, v, causal)
