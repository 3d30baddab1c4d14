"""Threefry-2x32 keys and draws, bit-compatible with ``jax.random``.

The JAX package draws inside its query plans from ``jax.random`` keys, and a
port query is held against it by handing both engines one key. So the port
keeps jax's key format (``uint32[2]``) and reproduces, in numpy ``uint32``
arithmetic, exactly the calls the selection path makes: `PRNGKey`, `split`,
`uniform`, `randint` and `categorical`.

Only jax's default mode, ``jax_threefry_partitionable=True``, is implemented:
random bits for an array of shape ``(n,)`` are the threefry hash of the
counter pairs ``(0, i)``, ``i < n``, and a split is the same hash read as key
pairs. Seeds follow jax with 64-bit mode off: the key is
``[0, seed mod 2**32]``.

`categorical` draws by Gumbel-max, as jax does. Its Gumbel noise takes two
float32 logarithms, and `log32` takes the logits' one: all three are
`repro_torch.core.bounds.xla_log32`, XLA's CPU log bit for bit, so the noise
and the logits are jax's to the bit.

>>> key = PRNGKey(0)
>>> key.tolist()
[0, 0]
>>> k1, k2 = split(key)
>>> randint(k1, (3,), 0, 10).shape
(3,)
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.bounds import xla_log32

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_F32_TINY = np.finfo(np.float32).tiny


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(d)
                                                          for d in shape)


def _as_key(key) -> np.ndarray:
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32[2], got shape {k.shape}")
    return k.astype(np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray) \
        -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)``."""
    k = _as_key(key)
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """jax's ``iota_2x32_shape``: the row-major flat index as (hi, lo)."""
    n = int(np.prod(shape, dtype=np.int64))
    flat = np.arange(n, dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — jax's public name
    """A key from an integer seed, as ``jax.random.PRNGKey`` makes it."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys, shape ``(num, 2)``, as ``jax.random.split``."""
    hi, lo = _counters((int(num),))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape: Shape) -> np.ndarray:
    """32 random bits per element, as jax's partitionable threefry."""
    hi, lo = _counters(_shape(shape))
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def uniform(key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """Float32 draws in ``[minval, maxval)``, as ``jax.random.uniform``.

    The top 23 bits become the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, f * (hi - lo) + lo)


def randint(key, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """Int32 draws in ``[minval, maxval)``, as ``jax.random.randint``.

    Two 32-bit draws per element, folded by jax's modulus formula in
    wrapping uint32 arithmetic."""
    info = np.iinfo(np.int32)
    lo = int(np.clip(minval, info.min, info.max))
    hi = int(np.clip(maxval, info.min, info.max))
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = np.uint32(1 if hi <= lo else (hi - lo) & 0xFFFFFFFF)
    mult = np.uint32((1 << 16) % int(span))
    mult = np.uint32(((int(mult) * int(mult)) & 0xFFFFFFFF) % int(span))
    with np.errstate(over="ignore"):
        off = (higher % span) * mult + (lower % span)
    off = off % span
    return (np.int64(lo) + off.astype(np.int64)).astype(np.int32)


def gumbel(key, shape: Shape) -> np.ndarray:
    """Float32 Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1)."""
    u = torch.from_numpy(np.asarray(uniform(key, shape, minval=_F32_TINY,
                                            maxval=1.0)))
    return (-xla_log32(-xla_log32(u))).numpy()


def categorical(key, logits, shape: Shape) -> np.ndarray:
    """Gumbel-max draws over a 1-D ``logits``, ``jax.random.categorical``
    with ``shape=(s,)``: noise is drawn as ``(s, len(logits))``."""
    logits = np.asarray(logits, np.float32)
    s = _shape(shape)
    g = gumbel(key, s + logits.shape)
    return np.argmax(g + logits, axis=-1).astype(np.int32)


def log32(x) -> np.ndarray:
    """Float32 natural log of a numpy array, ``jnp.log`` bit for bit
    (`xla_log32`; jax's logits for `categorical` are ``jnp.log`` of
    float32 masses)."""
    return xla_log32(torch.from_numpy(np.array(x, np.float32))).numpy()
