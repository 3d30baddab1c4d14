"""Confidence bounds (Lemma 1 of the paper), float32 torch.

    UB(mu, sigma, s, delta) = mu + sigma/sqrt(s) * sqrt(2 log 1/delta)
    LB(mu, sigma, s, delta) = mu - sigma/sqrt(s) * sqrt(2 log 1/delta)

``sigma`` is the plug-in *sample* standard deviation (Section 5.2).

Float32 sums are taken in a fixed association order, `tree_sum` and
`blocked_cumsum`, the orders XLA's CPU compiler gives ``jnp.sum`` and
``jnp.cumsum``. The estimators compare prefix curves against targets, so
an order that differs in the last bits could move tau; with the same order
the same sample gives the same tau in both packages, on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_SUM_WINDOW = 32      # XLA CPU's tree-reduction window
_SCAN_BLOCK = 16      # XLA CPU's blocked prefix-sum width


def _fold_columns(x2d: torch.Tensor) -> torch.Tensor:
    """Row sums of a 2-D float32 tensor, left to right from 0."""
    acc = torch.zeros(x2d.shape[0], dtype=x2d.dtype, device=x2d.device)
    for j in range(x2d.shape[1]):
        acc = acc + x2d[:, j]
    return acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum in XLA CPU's order: windows of 32 (zero padding split
    evenly before and after), summed left to right, recursively; the last
    32 or fewer left to right. Returns a 0-d tensor."""
    x = x.reshape(-1)
    while x.numel() > _SUM_WINDOW:
        n = x.numel()
        nb = -(-n // _SUM_WINDOW)
        pad = nb * _SUM_WINDOW - n
        x = _fold_columns(F.pad(x, (pad // 2, pad - pad // 2))
                          .view(nb, _SUM_WINDOW))
    return _fold_columns(x.view(1, -1))[0]


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum in XLA CPU's order: running sums inside
    blocks of 16, plus the (recursively scanned) totals of earlier blocks."""
    x = x.reshape(-1)
    n = x.numel()
    if n <= _SCAN_BLOCK:
        blocks = x.view(1, n)
    else:
        nb = -(-n // _SCAN_BLOCK)
        blocks = F.pad(x, (0, nb * _SCAN_BLOCK - n)).view(nb, _SCAN_BLOCK)
    cols = []
    acc = torch.zeros(blocks.shape[0], dtype=x.dtype, device=x.device)
    for j in range(blocks.shape[1]):
        acc = acc + blocks[:, j]
        cols.append(acc)
    inner = torch.stack(cols, dim=1)
    if blocks.shape[0] == 1:
        return inner.reshape(-1)[:n]
    prior = blocked_cumsum(inner[:, -1])
    excl = torch.cat([prior.new_zeros(1), prior[:-1]])
    return (inner + excl[:, None]).reshape(-1)[:n]


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64): torch's
    vectorized CPU sqrt is off by one unit in the last place for about one
    input in 150, where XLA's and numpy's are exact."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fma32(a, b, c) -> torch.Tensor:
    """Float32 a·b + c rounded once, as the FMA instructions that XLA's CPU
    backend contracts a multiply and an add into.

    Emulated in float64: the product of two float32 values is exact there,
    and the sum is rounded to float64 and then to float32. That double
    rounding could differ from one rounding in principle; the sweep of
    `xla_log32` (eleven such FMAs an input) against ``jnp.log`` in
    ``tests/test_torch_stats.py``, 1.5 million inputs, finds no case of
    it."""
    a = torch.as_tensor(a, dtype=torch.float32)
    return (a.double() * torch.as_tensor(b, dtype=torch.float32,
                                         device=a.device).double()
            + torch.as_tensor(c, dtype=torch.float32,
                              device=a.device).double()).float()


# Cephes' logf as XLA's CPU code holds it (float32 bit patterns): the
# fold point sqrt(1/2), the polynomial's nine coefficients and ln 2 split
# in two (q1 + q2).
_LOG_SQRTHF = 0x3F3504F3
_LOG_P = (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
          0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_LOG_Q1, _LOG_Q2 = 0xB95E8083, 0x3F318000
_F32_MIN_NORMAL = 0x00800000


def _bits32(b: int, like: torch.Tensor) -> torch.Tensor:
    """The float32 whose bit pattern is `b`, on `like`'s device."""
    b = b - (1 << 32) if b >= 1 << 31 else b
    return torch.tensor(b, dtype=torch.int32, device=like.device).view(
        torch.float32)


def flush32(x: torch.Tensor) -> torch.Tensor:
    """Float32 subnormals as zero (signed), as XLA's CPU code reads its
    inputs and writes its results (denormals-are-zero, flush-to-zero). A
    Beta(0.01, 1) corpus holds about 40% scores below 2^-126, which the
    reference's jnp samplers take as 0."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.where(x.abs() < _bits32(_F32_MIN_NORMAL, x), x * 0.0, x)


def xla_log32(x) -> torch.Tensor:
    """Float32 natural log, bit for bit ``jnp.log`` on XLA's CPU, on any
    device (a tensor stays where it lies; anything else becomes a CPU
    tensor).

    XLA's CPU log is Cephes' ``logf``, with the multiply-adds that its
    backend contracts into FMAs (`fma32`):

    * range reduction by bits: x = m·2^e, m in [0.5, 1); m below sqrt(1/2)
      folds to 2m − 1 with e − 1, else m − 1;
    * the polynomial in three interleaved Horner chains, each step an FMA,
      joined by two more FMAs in x³;
    * y = fma(y, x³, q1·e), q1·e rounded alone; x = fma(−½, x², x);
      x + y rounded; then fma(e, q2, ·).

    XLA's CPU code runs with subnormals read as zero, so a subnormal input
    gives −inf, as ±0 does; a negative input or nan gives nan (all bits
    set); +inf gives +inf.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    p = [_bits32(b, x) for b in _LOG_P]
    min_normal = _bits32(_F32_MIN_NORMAL, x)
    zero = x.abs() < min_normal                       # ±0 and subnormals
    nonpos = ~(x > 0)                                 # x <= 0 or nan
    inf = x == float("inf")

    bits = torch.where(x > min_normal, x, min_normal).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x807FFFFF - (1 << 32)) | 0x3F000000).view(torch.float32)
    fold = m < _bits32(_LOG_SQRTHF, x)
    r = (m - 1.0) + torch.where(fold, m, torch.zeros_like(m))
    e = e - fold.float()

    r2 = r * r
    r3 = r2 * r
    y0 = fma32(fma32(r, p[0], p[1]), r, p[2])
    y1 = fma32(fma32(r, p[3], p[4]), r, p[5])
    y2 = fma32(fma32(r, p[6], p[7]), r, p[8])
    y = fma32(fma32(y0, r3, y1), r3, y2)
    y = fma32(y, r3, e * _bits32(_LOG_Q1, x))
    r = fma32(r2, -0.5, r) + y
    out = fma32(e, _bits32(_LOG_Q2, x), r).view(torch.int32)

    # XLA's tail, in bits: nan for x <= 0, then −inf for zero, +inf for inf.
    out = out | -nonpos.int()
    special = zero.int() * (0xFF800000 - (1 << 32)) + inf.int() * 0x7F800000
    out = torch.where(zero | inf, special, out)
    return out.view(torch.float32)


def reciprocal32(v: int, like: torch.Tensor) -> torch.Tensor:
    """Float32 1/v on `like`'s device: what XLA multiplies by where the
    reference's jitted code divides by the constant v."""
    return torch.div(_f32(1.0, like), _f32(v, like))


def gaussian_width(sigma, s, delta) -> torch.Tensor:
    """Half-width sigma/sqrt(s) * sqrt(2 log(1/delta)) from Lemma 1.

    ``s`` is a sample size (a Python int, where the reference's jit sees a
    constant and multiplies by the float32 reciprocal of sqrt(s)) or a
    tensor of effective sizes (divided, and +inf where s == 0)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    delta = _f32(delta, sigma)
    spread = sqrt32(2.0 * xla_log32(torch.div(_f32(1.0, delta), delta)))
    if isinstance(s, int):
        if s <= 0:
            return torch.full_like(sigma, float("inf"))
        inv_root = torch.div(_f32(1.0, sigma), sqrt32(_f32(s, sigma)))
        return sigma * inv_root * spread
    s = _f32(s, sigma)
    w = sigma / sqrt32(torch.clamp_min(s, 1.0)) * spread
    return torch.where(s > 0, w, _f32(float("inf"), w))


def ub(mu, sigma, s, delta) -> torch.Tensor:
    """Upper confidence bound UB(mu, sigma, s, delta) — Eq. (7), as the
    reference computes it outside ``jit``: ``s`` (an int or a tensor of
    sizes) is a float32 tensor, divided by."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    return torch.as_tensor(mu, dtype=torch.float32) + gaussian_width(
        sigma, _f32(s, sigma), delta)


def lb(mu, sigma, s, delta) -> torch.Tensor:
    """Lower confidence bound LB(mu, sigma, s, delta) — Eq. (8), ``s`` as
    in `ub`."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    return torch.as_tensor(mu, dtype=torch.float32) - gaussian_width(
        sigma, _f32(s, sigma), delta)


def union_bound_split(delta, k) -> torch.Tensor:
    """delta/k failure-probability split for k simultaneous uses of
    Lemma 1 (float32)."""
    delta = torch.as_tensor(delta, dtype=torch.float32)
    return delta / _f32(k, delta)


def _vector(z) -> torch.Tensor:
    z = torch.as_tensor(z, dtype=torch.float32)
    if z.dim() != 1:
        raise ValueError(f"takes a 1-D sample, got shape {tuple(z.shape)}")
    return z


def sample_mean_std(z):
    """Plug-in (mu_hat, sigma_hat) of a 1-D sample, sigma_hat with the
    biased 1/n variance (Section 5), as the reference's ``jnp.mean`` and
    ``jnp.std`` (each one jitted computation): XLA's summation order; the
    mean a product with the float32 reciprocal of n, the variance a
    division by n. Up to 32 records XLA fuses the square into the
    variance's sum, which contracts each step into an FMA; past that the
    squares are rounded first and summed in `tree_sum`'s order."""
    z = _vector(z)
    mu = tree_sum(z) * reciprocal32(z.numel(), z)
    d = z - mu
    if z.numel() <= _SUM_WINDOW:
        total = _f32(0.0, z)
        for x in d:
            total = fma32(x, x, total)
    else:
        total = tree_sum(torch.square(d))
    return mu, sqrt32(total / _f32(z.numel(), z))


def weighted_mean_std(z, weights):
    """Mean/std of a 1-D importance-reweighted sample given multiplicities
    (with-replacement draws can repeat records)."""
    z, w = _vector(z), _vector(weights)
    tot = torch.clamp_min(tree_sum(w), 1e-30)
    mu = tree_sum(w * z) / tot
    var = tree_sum(w * torch.square(z - mu)) / tot
    return mu, sqrt32(var)


def prefix_mean_std(z):
    """(mu, sigma, n) of every prefix z[:i+1] of a 1-D array, all in one
    pass: entry i describes prefix length i+1."""
    z = _vector(z)
    n = torch.arange(1, z.numel() + 1, dtype=torch.float32, device=z.device)
    mu = blocked_cumsum(z) / n
    var = torch.clamp_min(blocked_cumsum(z * z) / n - mu * mu, 0.0)
    return mu, sqrt32(var), n


def masked_prefix_mean_std(z, mask):
    """Prefix statistics over the entries where ``mask`` is True: entry i
    gives (mu, sigma, n) over {z[j] : j <= i, mask[j]} (PT's Z(tau), a
    subset of the sample prefix)."""
    z = _vector(z)
    m = torch.as_tensor(mask).to(device=z.device, dtype=torch.float32)
    n = blocked_cumsum(m)
    safe_n = torch.clamp_min(n, 1.0)
    mu = blocked_cumsum(z * m) / safe_n
    var = torch.clamp_min(blocked_cumsum(z * z * m) / safe_n - mu * mu, 0.0)
    return mu, sqrt32(var), n


def sample_sum_std(z: torch.Tensor):
    """(sum, 1/n, sigma_hat) of a sample, sigma_hat with the biased 1/n
    variance: the pieces of mu_hat = sum · (1/n) that the reference's
    jitted estimators contract into the bound (`ub_of_sum`, `lb_of_sum`).

    Both divide by the constant n as those estimators do after XLA's
    rewrite: a product with the float32 reciprocal."""
    z = torch.as_tensor(z, dtype=torch.float32).reshape(-1)
    inv_n = reciprocal32(z.numel(), z)
    total = tree_sum(z)
    var = tree_sum(torch.square(z - total * inv_n)) * inv_n
    return total, inv_n, sqrt32(var)


def ub_of_sum(total, inv_n, sigma, s, delta) -> torch.Tensor:
    """UB with mu = total · inv_n, the product contracted into the add,
    fma(total, inv_n, width): what the reference's jitted estimators
    compute for mu + width."""
    return fma32(total, inv_n, gaussian_width(sigma, s, delta))


def lb_of_sum(total, inv_n, sigma, s, delta) -> torch.Tensor:
    """LB as `ub_of_sum`: fma(total, inv_n, −width), rounded once."""
    return fma32(total, inv_n, -gaussian_width(sigma, s, delta))


def weighted_prefix_mean_std(z: torch.Tensor, w: torch.Tensor):
    """Weighted (mu, sigma, ess) of every prefix z[:i+1] (Kish ESS), the
    variance csq/n − mu² as one FMA, as XLA's CPU backend compiles it
    under ``jit`` (the reference's precision scan)."""
    z = torch.as_tensor(z, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32)
    n = blocked_cumsum(w)
    csum = blocked_cumsum(z * w)
    csq = blocked_cumsum(z * z * w)
    safe_n = torch.clamp_min(n, 1e-30)
    mu = csum / safe_n
    var = torch.clamp_min(fma32(-mu, mu, csq / safe_n), 0.0)
    ess = (n * n) / torch.clamp_min(blocked_cumsum(w * w), 1e-30)
    return mu, sqrt32(var), ess
