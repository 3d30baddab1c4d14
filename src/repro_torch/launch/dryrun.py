"""Dry run of the distribution config: for every (architecture x input
shape) cell on the reference's production meshes, the specs of the
parameters, the AdamW moments, the batch and the decode caches, each
checked to divide its dims, and the bytes a device holds under them (the
JAX package's ``launch/dryrun.py``, without a compiler).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
        [--shape NAME] [--mesh single|multi|both] [--out FILE]

Everything is a shape: the model is built on the ``meta`` device and the
meshes are `launch.mesh.MeshShape`s, so no process group, no card and no
memory are needed. The JSON list at ``--out`` (default
``results/dryrun.json``) is rewritten after each cell, and a cell already
there is skipped, so a run that stops can go on.

A cell's record: ``arch``, ``shape``, ``mesh``, ``kind``, ``ok``,
``fsdp`` (`_fsdp_needed`), ``strategy``, ``divides`` and
``bytes_per_device``: ``params`` (the parameters in their dtypes),
``moments`` (mu and nu in float32, ZeRO-1 under "tp" training, the
parameters' specs under "dp"; 0 outside training), ``batch`` (int32
tokens, labels or positions) and ``caches`` (bf16 KV, latent and conv
caches, float32 recurrent states; 0 outside decode). A shape the config
does not take is recorded as skipped, as the reference records it.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import time

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import serve as servelib
from repro_torch.launch import sharding as shardlib
from repro_torch.launch import train as trainlib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as modellib
from repro_torch.models.meshctx import model_size

MESHES = (("single_pod_16x16", False), ("multi_pod_2x16x16", True))
# The reference's rule for FSDP: a TP-16 share of the bf16 parameters over
# 12e9 bytes, its TPU v5e's 16 GB HBM less headroom. Kept so that the
# specs are the reference's; it is not a budget of any card the port runs.
FSDP_BYTES = 12e9


def reduced_config(cfg, units):
    """cfg at full width with `units` repeating units (layers unrolled,
    no remat): the reference's cost-probe configs."""
    cfg = dataclasses.replace(cfg, unroll_layers=True, remat="none")
    if cfg.block == "mamba" and cfg.shared_attn_every:
        return dataclasses.replace(
            cfg, num_layers=units * cfg.shared_attn_every)
    if cfg.moe and cfg.moe_layer_step > 1:
        return dataclasses.replace(
            cfg, num_layers=units * cfg.moe_layer_step)
    if cfg.moe and cfg.first_k_dense:
        return dataclasses.replace(
            cfg, num_layers=cfg.first_k_dense + units)
    return dataclasses.replace(cfg, num_layers=units)


def unit_counts(cfg):
    """(units in cfg, units in `reduced_config(cfg, 1)`)."""
    if cfg.block == "mamba" and cfg.shared_attn_every:
        return cfg.num_layers / cfg.shared_attn_every, 1
    if cfg.moe and cfg.moe_layer_step > 1:
        return cfg.num_layers // cfg.moe_layer_step, 1
    if cfg.moe and cfg.first_k_dense:
        return cfg.num_layers - cfg.first_k_dense, 1
    return cfg.num_layers, 1


def _fsdp_needed(cfg, mesh) -> bool:
    """Whether the bf16 parameters' share of a TP group of the mesh's
    "model" size is over `FSDP_BYTES` (then FSDP, as the reference)."""
    return modellib.count_params_analytic(cfg) * 2 / model_size(mesh) \
        > FSDP_BYTES


@functools.lru_cache(maxsize=None)
def param_shapes(arch: str) -> dict:
    """{name: meta tensor} of `arch`'s model at full width."""
    model = modellib.init(get_config(arch), generator=torch.Generator(),
                          device="meta")
    return dict(model.named_parameters())


def _leaves(tree):
    """(tensor, spec) pairs of parallel trees of tensors and specs."""
    if isinstance(tree[0], dict):
        for k in tree[0]:
            yield from _leaves((tree[0][k], tree[1][k]))
    elif isinstance(tree[0], list):
        for a, b in zip(*tree):
            yield from _leaves((a, b))
    else:
        yield tree


def _bytes(pairs, mesh, itemsize=None) -> int:
    """Bytes a device holds of each (tensor, spec) pair: its block's
    elements times its element size (or `itemsize`)."""
    return sum(shardlib.local_numel(t.shape, spec, mesh)
               * (itemsize or t.element_size()) for t, spec in pairs)


def cell_record(arch, shape, mesh, mesh_name) -> dict:
    """The record of one (arch, shape, mesh) cell."""
    cfg = dataclasses.replace(get_config(arch), shard_activations=True)
    t0 = time.perf_counter()
    params = param_shapes(arch)
    fsdp = _fsdp_needed(cfg, mesh)
    train = shape.kind == "train"
    strategy = cfg.train_parallelism if train else "tp"
    pspecs = shardlib.param_specs(cfg, params, mesh, fsdp=fsdp,
                                  strategy=strategy)
    p_pairs = [(params[n], s) for n, s in pspecs.items()]
    m_pairs, c_pairs = [], []
    if train:
        (_, opt, bsh), _ = trainlib.shardings_for_train(
            cfg, params, None, mesh, fsdp=fsdp,
            batch_size=shape.global_batch)
        m_pairs = [(params[n], opt.mu[n].spec) for n in params] * 2
        batch = trainlib.input_specs_train(cfg, shape)
    else:
        (_, bsh, *rest), _ = servelib.shardings_for_serve(
            cfg, params, mesh, shape, shape.kind, fsdp=fsdp)
        if shape.kind == "prefill":
            batch = servelib.input_specs_prefill(cfg, shape)
        else:
            batch = servelib.input_specs_decode(cfg, shape)
            caches = servelib.cache_specs_struct(cfg, shape)
            c_pairs = list(_leaves((caches, shardlib.map_leaves(
                lambda sh: sh.spec, rest[0]))))
    b_pairs = [(batch[k], bsh[k].spec) for k in batch]
    every = p_pairs + m_pairs + b_pairs + c_pairs
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "kind": shape.kind, "ok": False, "fsdp": fsdp,
           "strategy": strategy,
           "divides": all(shardlib.divides(t.shape, spec, mesh)
                          for t, spec in every)}
    if rec["divides"]:
        rec["bytes_per_device"] = {
            "params": _bytes(p_pairs, mesh),
            "moments": _bytes(m_pairs, mesh, itemsize=4),
            "batch": _bytes(b_pairs, mesh),
            "caches": _bytes(c_pairs, mesh)}
        rec["ok"] = True
    rec["elapsed_s"] = round(time.perf_counter() - t0, 3)
    return rec


def main(argv=None) -> None:
    """The dry run's command line (see the module's docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    args = ap.parse_args(argv)

    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else []
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("ok")}
    meshes = [(name, make_production_mesh(multi_pod=multi))
              for name, multi in MESHES
              if args.mesh == "both" or name.startswith(args.mesh)]
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [s for s in SHAPES if args.shape in (None, s.name)]
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            ok, why = shape_applicable(cfg, shape)
            for mesh_name, mesh in meshes:
                key = (arch, shape.name, mesh_name)
                if key in done:
                    continue
                if not ok:
                    rec = {"arch": arch, "shape": shape.name,
                           "mesh": mesh_name, "ok": True, "skipped": why}
                else:
                    rec = cell_record(arch, shape, mesh, mesh_name)
                    print(f"[dryrun] {arch} x {shape.name} x {mesh_name}: "
                          f"{'OK' if rec['ok'] else 'FAIL'} "
                          f"{rec.get('bytes_per_device')}", flush=True)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                out_path.write_text(json.dumps(results, indent=1))
    n_ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK -> {out_path}")


if __name__ == "__main__":
    main()
