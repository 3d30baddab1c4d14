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


def log32(x: torch.Tensor) -> torch.Tensor:
    """Float32 natural log rounded from float64, the same on every device.
    XLA's CPU log is a polynomial that differs from it by one unit in the
    last place for some inputs, so bounds that take a log of delta can
    differ from the reference's in their last bit."""
    return torch.log(x.to(torch.float64)).to(torch.float32)


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
    spread = sqrt32(2.0 * log32(torch.div(_f32(1.0, delta), delta)))
    if isinstance(s, int):
        if s <= 0:
            return torch.full_like(sigma, float("inf"))
        inv_root = torch.div(_f32(1.0, sigma), sqrt32(_f32(s, sigma)))
        return sigma * inv_root * spread
    s = _f32(s, sigma)
    w = sigma / sqrt32(torch.clamp_min(s, 1.0)) * spread
    return torch.where(s > 0, w, _f32(float("inf"), w))


def ub(mu, sigma, s, delta) -> torch.Tensor:
    """Upper confidence bound UB(mu, sigma, s, delta) — Eq. (7)."""
    return torch.as_tensor(mu, dtype=torch.float32) + gaussian_width(
        sigma, s, delta)


def lb(mu, sigma, s, delta) -> torch.Tensor:
    """Lower confidence bound LB(mu, sigma, s, delta) — Eq. (8)."""
    return torch.as_tensor(mu, dtype=torch.float32) - gaussian_width(
        sigma, s, delta)


def sample_mean_std(z: torch.Tensor):
    """Plug-in (mu_hat, sigma_hat) with the biased 1/n variance.

    Both divide by the constant n as the reference's jitted estimators
    do after XLA's rewrite: a product with the float32 reciprocal."""
    z = torch.as_tensor(z, dtype=torch.float32).reshape(-1)
    inv_n = reciprocal32(z.numel(), z)
    mu = tree_sum(z) * inv_n
    var = tree_sum(torch.square(z - mu)) * inv_n
    return mu, sqrt32(var)


def weighted_prefix_mean_std(z: torch.Tensor, w: torch.Tensor):
    """Weighted (mu, sigma, ess) of every prefix z[:i+1] (Kish ESS)."""
    z = torch.as_tensor(z, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32)
    n = blocked_cumsum(w)
    csum = blocked_cumsum(z * w)
    csq = blocked_cumsum(z * z * w)
    safe_n = torch.clamp_min(n, 1e-30)
    mu = csum / safe_n
    var = torch.clamp_min(csq / safe_n - mu * mu, 0.0)
    ess = (n * n) / torch.clamp_min(blocked_cumsum(w * w), 1e-30)
    return mu, sqrt32(var), ess
