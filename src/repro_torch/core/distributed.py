"""Distributed SUPG selection plane on ``torch.distributed``: collective
reductions and two-level sampling.

Scores are sharded over a process group's ranks, which stand for the JAX
package's mesh data axes ("pod", "data"): a rank holds its local shard,
where the reference takes the global array under ``shard_map``. Three
collective patterns cover everything SUPG needs:

  1. global sketch        : each rank's sketch (one ``score_hist`` launch
                            on the card, its plain version on the CPU) and
                            one all-reduce of the (3, B) float32 sketch —
                            B = 4096 bins => 48 KiB on the wire,
                            independent of n.
  2. two-level sampling   : a multinomial over shards (from the gathered
                            shard weight totals), then a within-shard
                            categorical; the paper's with-replacement
                            semantics exactly.
  3. threshold selection  : a local filter A(x) >= tau; its global size is
                            a local count (``threshold_count`` on the card)
                            and one all-reduce of an exact int64.

The caller initialises the group (``gloo`` on the CPU, and for ranks that
share one card; ``nccl`` on the card, one rank a card), through a
``FileStore`` or a ``file://`` method where no network is wanted. Every
function that takes a group defaults to the world and raises when no group
is initialised. `two_level_sample` and `within_shard_probs` are local.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random
from repro_torch.core import binned, bounds
from repro_torch.kernels.score_hist import ops as hist_ops
from repro_torch.kernels.threshold_select import ops as select_ops


def _group(group):
    """`group`, or the world; raises when no group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised: call "
            "torch.distributed.init_process_group first")
    return dist.group.WORLD if group is None else group


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(like.device)


def _shard(local_scores) -> torch.Tensor:
    """A rank's shard as a contiguous 1-D float32 tensor."""
    if not isinstance(local_scores, torch.Tensor):
        local_scores = torch.from_numpy(
            np.ascontiguousarray(local_scores, np.float32))
    return local_scores.to(torch.float32).reshape(-1).contiguous()


def _raw(local: torch.Tensor, scheme: str) -> torch.Tensor:
    """sqrt(A) or A, A clipped to [0, 1] with subnormals as zero (as the
    reference's jnp reads them)."""
    a = bounds.flush32(torch.clamp(local, 0.0, 1.0))
    return bounds.sqrt32(a) if scheme == "sqrt" else a


def global_sketch(local_scores, num_bins: int = binned.DEFAULT_BINS,
                  group=None) -> binned.ScoreSketch:
    """The global ScoreSketch of a sharded score vector: this rank's
    sketch, then one all-reduce (sum) of its (3, B) float32 rows. Counts
    are exact wherever each float32 partial sum is (below 2^24 a bin);
    sums add the ranks' float32 sketches in the backend's order."""
    g = _group(group)
    sketch = torch.stack(list(binned.build_sketch(_shard(local_scores),
                                                  num_bins)))
    dist.all_reduce(sketch, op=dist.ReduceOp.SUM, group=g)
    return binned.ScoreSketch(sketch[0], sketch[1], sketch[2])


def shard_weight_totals(local_scores, scheme: str = "sqrt", kappa=0.1,
                        group=None) -> torch.Tensor:
    """Per-shard unnormalized weight mass, all-gathered to every rank:
    (world size, 2) float32 rows (Σ raw weight, record count), raw = sqrt(A)
    or A — the first level of the two-level sampler (`kappa` enters there).

    Σ is the reference's float32 tree sum on the CPU; on the card it is
    the float64 mass of one ``score_hist`` launch, rounded once to
    float32."""
    g = _group(group)
    local = _shard(local_scores)
    if local.device.type == "cpu":
        total = bounds.tree_sum(_raw(local, scheme))
    else:
        masses = torch.empty(2, dtype=torch.float64, device=local.device)
        hist_ops.score_hist(local, binned.DEFAULT_BINS, masses=masses)
        total = masses[0 if scheme == "sqrt" else 1].to(torch.float32)
    pair = torch.stack([total, _f32(float(np.float32(local.numel())),
                                    local)])
    rows = [torch.empty_like(pair) for _ in range(dist.get_world_size(g))]
    dist.all_gather(rows, pair, group=g)
    return torch.stack(rows)


def two_level_sample(key, shard_totals, s: int, kappa=0.1):
    """Allocate s with-replacement draws across shards, then within shards.

    shard_totals: (num_shards, 2) of (raw weight mass, record count).
    Returns (shard_ids, per_draw_keys), int32 (s,) and uint32 (s, 2) host
    numpy, for the caller to dispatch within-shard draws. The joint
    distribution equals the global defensive-mixed categorical exactly:
        p(x) = (1-kappa) raw(x)/Z + kappa/n_total.
    """
    t = torch.as_tensor(shard_totals, dtype=torch.float32).cpu()
    raw, counts = t[:, 0], t[:, 1]
    z = torch.clamp_min(bounds.tree_sum(raw), 1e-30)
    n_total = torch.clamp_min(bounds.tree_sum(counts), 1.0)
    mass = (bounds.flush32(_f32(1.0 - kappa, t) * raw) / z
            + bounds.flush32(_f32(kappa, t) * counts) / n_total)
    mass = mass / bounds.tree_sum(mass)
    k_alloc, k_draws = random.split(key)
    logits = random.log32(torch.clamp_min(mass, 1e-38).numpy())
    return (random.categorical(k_alloc, logits, (s,)),
            random.split(k_draws, s))


def within_shard_probs(local_scores, raw_total, n_total, scheme="sqrt",
                       kappa=0.1):
    """Per-record global draw probabilities inside one shard, and the m(x)
    reweighting factors (1/n_total)/p_global(x), on the shard's device.

    Conditional on a draw landing in this shard, a record's probability is
    proportional to its global defensive-mixed weight, computed locally
    from the gathered normalizers — no global score materialization."""
    local = _shard(local_scores)
    raw = _raw(local, scheme)
    rt = torch.clamp_min(_f32(raw_total, local), 1e-30)
    nt = torch.clamp_min(_f32(n_total, local), 1.0)
    p_global = (bounds.flush32(bounds.flush32(_f32(1.0 - kappa, local) * raw)
                               / rt)
                + torch.div(_f32(kappa, local), nt))
    m = torch.div(torch.div(_f32(1.0, local), nt),
                  bounds.flush32(torch.clamp_min(p_global, 1e-38)))
    return p_global, m


def local_selection(local_scores, tau, group=None) -> torch.Tensor:
    """This rank's filter mask {A(x) >= tau} (float32 compare): stays
    sharded, no communication."""
    _group(group)
    local = _shard(local_scores)
    return local >= _f32(float(np.float32(tau)), local)


def global_selection_count(local_scores, tau, group=None) -> torch.Tensor:
    """|{A(x) >= tau}| over every rank's shard, an exact 0-d int64 tensor
    on the shard's device: a local count (one ``threshold_count`` launch
    on the card, `select_ops.count_at_least`) and one all-reduce. The
    reference sums float32 counts, which equal this below 2^24."""
    g = _group(group)
    local = _shard(local_scores)
    count = select_ops.count_at_least(local, float(np.float32(tau))).reshape(
        1).clone()
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=g)
    return count[0]
