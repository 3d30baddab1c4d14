"""Atomic, keep-k, optionally asynchronous checkpoints of the trainer's
state (the JAX package's ``ckpt/checkpoint.py``), in the reference's
on-disk format, so that either package restores what the other wrote:

    <dir>/step_%010d/shard_%05d.npz   arr_i, the leaves of (params,
                                      opt_state) in jax's flatten order
    <dir>/step_%010d/manifest.json    {"step", "num_leaves",
                                      "treedef_repr", "extra"}

A checkpoint is staged under ``<dir>/tmp.<step>.<process>`` and published
by `durable.atomic.publish_dir` (a rename and a directory fsync); the
last ``keep`` survive, and stale staging directories of crashed writers
are removed. `save_async` copies the state to host memory at once and
writes it on a thread; the next call waits for it.

The port's model is saved in the reference's layout
(`models.model.params_to_reference`: each block's weights stacked on the
leading axes, dict keys in sorted order) and its `AdamWState` as the
reference's ``AdamWState(step, mu, nu)`` with mu and nu in the same
layout; bf16 arrays are written as numpy writes the reference's, raw
2-byte words (``|V2``). A manager that knows the model's config (given,
or taken from the model it saved) restores the port's model and
optimizer state on its device; without one, the saved tree comes back
with its leaves as tensors. An elastic restore onto a ``DeviceMesh``
(``mesh``, ``specs``: `launch.sharding.param_specs` of the model, or a
tree of specs like the saved one) brings each parameter back as a DTensor
placed by its spec; every rank reads the whole file and keeps its block,
so nothing is sent, and each leaf's ``full_tensor()`` is the plain
restore's, bit for bit (the reference's ``device_put`` onto
``NamedSharding``). The optimizer state comes back whole, as the
reference's does.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.durable.atomic import publish_dir
from repro_torch.launch import sharding
from repro_torch.models import model as modellib
from repro_torch.optim.adamw import AdamWState


class CheckpointManager:
    """Checkpoints under `directory`, the last `keep` kept. `cfg` is the
    model's config (taken from the first model saved if not given);
    `device` is where `restore` puts tensors (None: ``cuda``)."""

    def __init__(self, directory, keep: int = 3, process_index: int = 0, *,
                 cfg=None, device=None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.process_index = process_index
        self.cfg = cfg
        self.device = device
        self._async_thread: Optional[threading.Thread] = None

    # -- public API ---------------------------------------------------------

    def save(self, step: int, params, opt_state=None, extra: dict = None):
        """Write `step`'s checkpoint of `params` (the port's model, or any
        tree of tensors and arrays) and `opt_state`."""
        self._wait_async()
        self._save_sync(step, self._host(params, opt_state), extra or {})

    def save_async(self, step: int, params, opt_state=None,
                   extra: dict = None):
        """`save` on a background thread, after a copy to host memory
        made now (the tensors may change under the next step)."""
        self._wait_async()
        host = self._host(params, opt_state)
        extra = dict(extra or {})
        self._async_thread = threading.Thread(
            target=self._save_sync, args=(step, host, extra), daemon=True)
        self._async_thread.start()

    def restore(self, step: Optional[int] = None, mesh=None, specs=None,
                device=None):
        """(params, opt_state, step, extra) of `step` (the latest if None):
        the port's model and `AdamWState` where the manager knows the
        config, else the saved tree with tensors for leaves, on `device`
        (the manager's if None; ``cuda`` if neither names one). With a
        ``DeviceMesh`` `mesh` and `specs` ({parameter name: spec} for a
        model, else a tree of specs like the saved params; None or a
        missing name: whole), everything is on the mesh's device type and
        the parameters are DTensors placed by their specs."""
        if (mesh is None) != (specs is None):
            raise ValueError("a restore onto a mesh needs both mesh and "
                             "specs")
        self._wait_async()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        data = np.load(d / f"shard_{self.process_index:05d}.npz",
                       allow_pickle=False)
        leaves = iter([data[f"arr_{i}"]
                       for i in range(manifest["num_leaves"])])
        params, opt_state = _unflatten(manifest["treedef_repr"], leaves)
        named = self.device if device is None else device
        if mesh is None:
            dev = resolve_device(named)
        else:
            dev = resolve_device(mesh.device_type)
            if named is not None and torch.device(named).type != dev.type:
                raise ValueError(f"a restore onto a {dev.type} mesh cannot "
                                 f"put its leaves on {named}")
        if self.cfg is not None:
            params = modellib.params_from_reference(params, self.cfg,
                                                    device=dev)
            if isinstance(opt_state, AdamWState):
                names = [n for n, _ in params.named_parameters()]
                opt_state = AdamWState(
                    step=modellib._tensor(opt_state.step, dev),
                    mu=modellib.from_reference(opt_state.mu, names,
                                               device=dev),
                    nu=modellib.from_reference(opt_state.nu, names,
                                               device=dev))
        else:
            params, opt_state = (_to_tensors(t, dev)
                                 for t in (params, opt_state))
        if mesh is not None:
            params = _onto_mesh(params, specs, mesh)
        return params, opt_state, step, manifest.get("extra", {})

    def latest_step(self) -> Optional[int]:
        """The newest published step, None if there is none."""
        self._wait_async()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """Every published step, in order."""
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if p.is_dir())

    # -- internals -----------------------------------------------------------

    def _host(self, params, opt_state):
        """(params, opt_state) as the reference's trees of numpy arrays."""
        if isinstance(params, nn.Module):
            if self.cfg is None:
                self.cfg = params.cfg
            if isinstance(opt_state, AdamWState):
                opt_state = AdamWState(
                    step=_host_leaf(opt_state.step),
                    mu=modellib.to_reference(opt_state.mu),
                    nu=modellib.to_reference(opt_state.nu))
            params = modellib.params_to_reference(params)
        return _to_host(params), _to_host(opt_state)

    def _save_sync(self, step, tree, extra):
        leaves = []
        skeleton = _skeleton_repr(tree, leaves)
        tmp = self.dir / f"tmp.{step:010d}.{self.process_index}"
        final = self.dir / f"step_{step:010d}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / f"shard_{self.process_index:05d}.npz",
                 **{f"arr_{i}": leaf for i, leaf in enumerate(leaves)})
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "treedef_repr": skeleton,
            "extra": extra,
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        publish_dir(tmp, final)         # atomic publish (rename + dir fsync)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for p in self.dir.glob("tmp.*"):
            shutil.rmtree(p, ignore_errors=True)

    def _wait_async(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None


# Trees: dicts (flattened in sorted key order, as jax flattens them),
# lists, tuples and named tuples (named in the manifest, as the reference
# names AdamWState), None (no leaves) and array leaves.

def _host_leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return modellib._numpy(x)
    return np.asarray(x)


def _to_host(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        vals = [_to_host(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return _host_leaf(tree)


def _to_tensors(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_to_tensors(v, device) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return modellib._tensor(tree, device)


def _onto_mesh(params, specs, mesh):
    """`params` (a model, or a tree of tensors) with each leaf a DTensor
    on `mesh` placed by its spec in `specs`."""
    if isinstance(params, nn.Module):
        for name, p in list(params.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = params.get_submodule(owner) if owner else params
            spec = specs.get(name) or (None,) * p.ndim
            setattr(module, leaf, nn.Parameter(
                sharding.distribute(p.detach(), spec, mesh),
                requires_grad=False))
        return params
    if isinstance(params, dict):
        return {k: _onto_mesh(v, (specs or {}).get(k), mesh)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        vals = [_onto_mesh(v, None if specs is None else specs[i], mesh)
                for i, v in enumerate(params)]
        return type(params)(*vals) if hasattr(params, "_fields") \
            else type(params)(vals)
    if params is None:
        return None
    return sharding.distribute(params, specs or (None,) * params.ndim, mesh)


def _skeleton_repr(tree, leaves: list):
    """The reference's manifest skeleton of `tree`, its leaves appended to
    `leaves` in flatten order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"__d__": {k: _skeleton_repr(tree[k], leaves)
                          for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        tag = "__t__" if isinstance(tree, tuple) else "__l__"
        named = type(tree).__name__ if hasattr(tree, "_fields") else None
        return {tag: [_skeleton_repr(v, leaves) for v in tree],
                "named": named}
    leaves.append(tree)
    return "__leaf__"


def _unflatten(rep, leaves):
    """The tree of a manifest skeleton, its leaves drawn from the iterator
    `leaves` in flatten order (dicts in sorted key order, whatever order
    the skeleton lists them in)."""
    if rep is None:
        return None
    if rep == "__leaf__":
        return next(leaves)
    if "__d__" in rep:
        d = rep["__d__"]
        return {k: _unflatten(d[k], leaves) for k in sorted(d)}
    for tag, ctor in (("__t__", tuple), ("__l__", list)):
        if tag in rep:
            vals = [_unflatten(v, leaves) for v in rep[tag]]
            if rep.get("named") == "AdamWState":
                return AdamWState(*vals)
            return ctor(vals)
    raise ValueError(f"bad skeleton node {rep!r}")
