"""Parameter, batch and cache specs: the TP/EP/DP layout rules (the JAX
package's ``launch/sharding.py``).

A spec is a tuple with a ``PartitionSpec``'s entries, one per dim: None
(whole), an axis name, or a tuple of names (the dim split over those axes,
the first outermost). The rules are the reference's, by (path, shape)
pattern:

  embedding table (V, d)           -> vocab-sharded  ("model", None)
  column-parallel producers        -> last dim "model"   (wq/wk/wv/w_gate/...)
  row-parallel consumers           -> first matrix dim "model" (wo/w_down/...)
  MoE expert stacks (E, d, ff)     -> expert-parallel: E over "model"
  MLA latent down-projections      -> replicated
  norms / biases-1D / scalars      -> replicated

Every axis is checked against the dim it splits; one that does not divide
it is dropped (the dim stays whole there).

The reference stacks each block's weights (and caches) on leading axes,
and several rules read a leaf's rank, size or extents: ZeRO-1 shards a
stacked per-block vector such as ``body/blocks/ln2/scale`` (32, 960) on
its 960, where the port's leaf is a 1-D (960,) that the rule would skip.
So every spec here is computed on the reference's stacked shape (names
through `models.model.reference_path`), and the stacked entries are then
dropped. No rule puts an axis on a stacked entry for any config on the
meshes this package names; where one would, that raises.

`placements` turns a spec into a ``DeviceMesh``'s placements
(``Shard(dim)`` or ``Replicate()`` per mesh dim), `local_chunk` takes a
rank's block of a whole tensor, and `local_numel` counts it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.launch.mesh import data_axes
from repro_torch.models.meshctx import axis_sizes
from repro_torch.models.model import reference_path

# leaf names (last path component) -> role
_COLUMN = {"wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "cm_wk", "cm_wr",
           "w_uq", "w_uk", "w_uv", "maa_w1", "wd1"}
_ROW = {"wo", "w_down", "cm_wv", "out_proj", "w"}
_BIAS_MODEL = {"bq", "bk", "bv"}

_FSDP_MIN_ELEMS = 1 << 22  # 4M: smaller leaves are not FSDP-sharded


def _axes(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _check(spec, shape, mesh) -> tuple:
    """`spec` with each entry whose axes do not divide its dim dropped."""
    sizes = axis_sizes(mesh)
    return tuple(None if entry is None or dim % math.prod(
        sizes[a] for a in _axes(entry)) else entry
        for dim, entry in zip(shape, spec))


def _leaf_spec(names, shape) -> tuple:
    """The pattern for one leaf of the reference's stacked tree; leading
    stack axes (layers, experts, codebooks, super-blocks) are recognized
    by rank surplus."""
    name = names[-1]
    rank = len(shape)
    if name == "table":                       # embedding (maybe (K,) V, d)
        return (None,) * (rank - 2) + ("model", None)
    if name in _BIAS_MODEL and rank >= 1:
        return (None,) * (rank - 1) + ("model",)
    if name == "scale" or rank <= 1:
        return (None,) * rank
    if "moe" in names and name in ("w_gate", "w_up", "w_down"):
        return (None,) * (rank - 3) + ("model", None, None)   # EP on E
    if name == "w" and "head" in names:       # LM head (maybe (K,) d, V)
        return (None,) * (rank - 2) + (None, "model")
    if name in _COLUMN:
        return (None,) * (rank - 1) + ("model",)
    if name in _ROW:
        return (None,) * (rank - 2) + ("model", None)
    return (None,) * rank      # router, MLA down-projections, conv, ...: whole


def _stacked(named: Dict[str, tuple]) -> Dict[str, tuple]:
    """{port name: (reference keys, stacked-axis count, the reference's
    stacked shape)} of {port name: port shape}."""
    extents: dict = {}
    for name in named:
        keys, index = reference_path(name)
        prev = extents.get(keys, (0,) * len(index))
        extents[keys] = tuple(max(a, i + 1) for a, i in zip(prev, index))
    out = {}
    for name, shape in named.items():
        keys, index = reference_path(name)
        out[name] = (keys, len(index), extents[keys] + tuple(shape))
    return out


def _unstack(spec, lead: int, what: str, mesh) -> tuple:
    """`spec` without its first `lead` (stacked) entries, which must split
    nothing (None, or axes of size 1): a stacked axis split over ranks has
    no place in the port's unstacked leaves."""
    sizes = axis_sizes(mesh)
    if any(math.prod(sizes[a] for a in _axes(e)) > 1 for e in spec[:lead]):
        raise ValueError(f"{what}: the reference's spec {spec} puts a mesh "
                         f"axis on a stacked axis")
    return tuple(spec[lead:])


def _shapes(params) -> Dict[str, tuple]:
    """{name: shape} of a model, or of a {name: tensor or shape} dict."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(getattr(p, "shape", p)) for n, p in params.items()}


def param_specs(cfg, params, mesh, fsdp=False, strategy="tp") -> dict:
    """{parameter name: spec} of the port's model `params` (or a {name:
    tensor or shape} dict, meta tensors included) on `mesh`, each the
    reference's spec of its stacked leaf with the stacked entries dropped.

    strategy "tp": the TP/EP patterns; with `fsdp` also each leaf of 4M
    elements or more split over the data axes on its largest dim that
    takes them (ZeRO-3). strategy "dp": no tensor parallelism; each leaf of
    65536 elements or more split over every mesh axis on its largest dim
    that takes them, the rest whole."""
    dp = data_axes(mesh)
    lead = dp if len(dp) > 1 else dp[0]
    all_axes = tuple(axis_sizes(mesh))

    def assign(names, shape):
        size = math.prod(shape)
        if strategy == "dp":
            if len(shape) < 1 or size < (1 << 16):
                return (None,) * len(shape)
            for _, i in sorted(((shape[i], i) for i in range(len(shape))),
                               reverse=True):
                trial = [None] * len(shape)
                trial[i] = all_axes
                fixed = _check(trial, shape, mesh)
                if fixed[i] is not None:
                    return fixed
            return (None,) * len(shape)
        spec = _check(_leaf_spec(names, shape), shape, mesh)
        if fsdp and len(shape) >= 2 and size >= _FSDP_MIN_ELEMS:
            cand = [(shape[i], i) for i, e in enumerate(spec) if e is None]
            for _, i in sorted(cand, reverse=True):
                trial = list(spec)
                trial[i] = lead
                fixed = _check(trial, shape, mesh)
                if fixed[i] is not None:
                    return fixed
        return spec

    return {name: _unstack(assign(keys, shape), n_lead, name, mesh)
            for name, (keys, n_lead, shape)
            in _stacked(_shapes(params)).items()}


def zero1_specs(cfg, params, mesh, fsdp=False) -> dict:
    """{parameter name: spec} of the AdamW moments (ZeRO-1): the
    parameter's spec (`param_specs`, strategy "tp") plus the data axes on
    the largest dim of the reference's stacked leaf that is still whole
    and divides by their size, unless the leaf is already data-sharded or
    has fewer than 2 stacked dims."""
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_total = math.prod(sizes[a] for a in dp)
    pspecs = param_specs(cfg, params, mesh, fsdp=fsdp)

    def extend(spec, shape):
        if len(shape) < 2:
            return spec
        used = {a for e in spec for a in _axes(e)}
        if used & set(dp):
            return spec
        cand = [(shape[i], i) for i, e in enumerate(spec)
                if e is None and shape[i] % dp_total == 0]
        if not cand:
            return spec
        _, i = max(cand)
        spec = list(spec)
        spec[i] = dp if len(dp) > 1 else dp[0]
        return tuple(spec)

    out = {}
    for name, (_, n_lead, shape) in _stacked(_shapes(params)).items():
        full = (None,) * n_lead + pspecs[name]
        out[name] = _unstack(extend(full, shape), n_lead, name, mesh)
    return out


# ---------------------------------------------------------------------------
# Input / cache specs
# ---------------------------------------------------------------------------

def batch_spec(mesh, extra_dims=1, batch=None, axes="data") -> tuple:
    """(B, ...) split over the data axes (or, with axes="all", every axis:
    the "dp" training strategy). With `batch` given, the axis sets narrow
    until one divides B (long_500k's global batch of 1 ends whole)."""
    dp = data_axes(mesh)
    candidates = []
    if axes == "all":
        candidates.append(tuple(axis_sizes(mesh)))
    candidates.append(dp if len(dp) > 1 else dp[0])
    if len(dp) > 1:
        candidates.append(dp[-1])
    for lead in candidates:
        spec = (lead,) + (None,) * extra_dims
        if batch is None:
            return spec
        fixed = _check(spec, (batch,) + (1,) * extra_dims, mesh)
        if fixed[0] is not None:
            return fixed
    return (None,) * (1 + extra_dims)


def _cache_leaf_spec(name, shape, mesh, batch, lead) -> tuple:
    """The reference's rule for one cache leaf of its stacked layout."""
    rank = len(shape)
    if name in ("k", "v") and rank >= 4:            # (L?, B, S, KV, hd)
        n = rank - 4
        spec = _check((None,) * n + (lead, None, "model", None), shape, mesh)
        if spec[n + 2] is None:
            # KV heads do not divide the model axis: split the cache's
            # sequence instead (the flash-decode layout)
            spec = _check((None,) * n + (lead, "model", None, None), shape,
                          mesh)
        return spec
    if name in ("c", "k_rope") and rank >= 3:       # MLA latent (L?, B, S, r)
        return _check((None,) * (rank - 3) + (lead, "model", None), shape,
                      mesh)
    if name in ("wkv", "ssm") and rank >= 4:        # (L?, B, H, dk, dv)
        return _check((None,) * (rank - 4) + (lead, "model", None, None),
                      shape, mesh)
    # shift and conv states (L?, B, ...): the first dim whose extent equals
    # the batch, stacked dims included, as the reference's rule reads them
    for i, d in enumerate(shape):
        if d == batch:
            cand = _check((None,) * i + (lead,) + (None,) * (rank - i - 1),
                          shape, mesh)
            return cand if cand[i] is not None else (None,) * rank
    return (None,) * rank


def cache_specs(cfg, caches, mesh, batch):
    """Specs of the port's decode caches `caches` (nested dicts and lists
    of tensors, meta tensors included), in the same structure: batch over
    the data axes, the KV-head dim over "model" where it divides, else the
    cache's sequence. Each is the reference's spec of its stacked leaf (a
    list is a stacked axis) with the stacked entries dropped."""
    dp = data_axes(mesh)
    lead = dp if len(dp) > 1 else dp[0]

    def extents(node):
        """The stacked extents under `node`: a list's length, then its
        first entry's."""
        if isinstance(node, list):
            return (len(node),) + extents(node[0])
        return ()

    def walk(node, keys, stack):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,), stack) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, keys, stack) for v in node]
        shape = stack + tuple(node.shape)
        spec = _cache_leaf_spec(keys[-1], shape, mesh, batch, lead)
        return _unstack(spec, len(stack), "/".join(keys), mesh)

    return {k: walk(v, (k,), extents(v)) for k, v in caches.items()}


# ---------------------------------------------------------------------------
# Specs on a mesh
# ---------------------------------------------------------------------------

def map_leaves(fn, tree):
    """`fn` on each leaf of nested dicts and lists (a cache's specs or
    shardings)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        """The spec as the mesh's placements (`placements`)."""
        return placements(self.spec, self.mesh)


def param_shardings(cfg, params, mesh, fsdp=False, strategy="tp") -> dict:
    """{parameter name: `Sharding`} of `param_specs`."""
    return {n: Sharding(mesh, s) for n, s in param_specs(
        cfg, params, mesh, fsdp=fsdp, strategy=strategy).items()}


def placements(spec, mesh) -> list:
    """`spec` as a ``DeviceMesh``'s placements, one per mesh dim:
    ``Shard(d)`` where the spec splits tensor dim d over that axis, else
    ``Replicate()``. A dim split over several axes (a tuple entry) is
    split over them in mesh order, the first outermost, as a DTensor nests
    its shards. Raises where a placement cannot say it: an axis the mesh
    lacks or used twice, or a tuple that is not in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        order = []
        for a in _axes(entry):
            if a not in names or a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} is not a free "
                                 f"axis of the mesh {names}")
            seen.add(a)
            order.append(names.index(a))
            out[names.index(a)] = Shard(dim)
        if order != sorted(order):
            raise ValueError(f"spec {spec}: a DTensor splits a dim over "
                             f"several mesh axes in mesh order {names}, "
                             f"not as {entry}")
    return out


def _parts(shape, spec, mesh) -> list:
    """The blocks each dim of `shape` splits into under `spec` (a spec
    shorter than the shape leaves the rest whole)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return [math.prod(sizes[a] for a in _axes(e)) for e in spec]


def divides(shape, spec, mesh) -> bool:
    """Whether `spec` splits each dim of `shape` evenly."""
    return all(d % n == 0 for d, n in zip(shape, _parts(shape, spec, mesh)))


def local_numel(shape, spec, mesh) -> int:
    """Elements of one rank's block of a `shape` tensor under `spec`."""
    if not divides(shape, spec, mesh):
        raise ValueError(f"spec {spec} does not divide {tuple(shape)}")
    return math.prod(d // n for d, n in zip(shape, _parts(shape, spec,
                                                          mesh)))


def local_chunk(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec` on the
    ``DeviceMesh`` `mesh` (a view): the block a DTensor with
    `placements`(spec) holds here."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    sizes = list(axis_sizes(mesh).values())
    for i, p in enumerate(placements(spec, mesh)):
        if isinstance(p, Shard):
            n = t.shape[p.dim]
            if n % sizes[i]:
                raise ValueError(f"spec {spec} does not divide "
                                 f"{tuple(t.shape)}")
            step = n // sizes[i]
            t = t.narrow(p.dim, coord[i] * step, step)
    return t


def distribute(t: torch.Tensor, spec, mesh):
    """The whole tensor `t` (the same on every rank) as a DTensor on the
    ``DeviceMesh`` `mesh` placed by `spec`: each rank keeps its block, and
    nothing is sent."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_chunk(t, spec, mesh).contiguous(), mesh,
                              placements(spec, mesh), run_check=False)
