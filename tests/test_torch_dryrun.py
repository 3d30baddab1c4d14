"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's, on the CPU.

The reference's dry run forces 512 host devices when it is imported, so
its `reduced_config`, `unit_counts` and `_fsdp_needed` (on its production
meshes) run in a subprocess, and the port's must equal them on every
config. Each cell's bytes a device holds (parameters, ZeRO-1 moments,
batch, decode caches) must equal those reckoned here from the reference's
own specs and shapes (`repro.launch.sharding` on meshes of repeated CPU
devices, `jax.eval_shape` of its init and caches), exactly: they are
integers. The command line writes its JSON a cell at a time and skips
the cells it has, and importing the module leaves the process's
environment as it was.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import sharding as jshard  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

_REFERENCE = textwrap.dedent("""
    import sys
    sys.path.insert(0, "src")
    import dataclasses, json
    from repro.launch import dryrun
    from repro.launch.mesh import make_production_mesh
    from repro.configs import ARCH_IDS, get_config
    meshes = {"single": make_production_mesh(),
              "multi": make_production_mesh(multi_pod=True)}
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        out[arch] = {
            "units": list(dryrun.unit_counts(cfg)),
            "reduced": [dataclasses.asdict(dryrun.reduced_config(cfg, u))
                        for u in (1, 2)],
            "fsdp": {k: bool(dryrun._fsdp_needed(cfg, m))
                     for k, m in meshes.items()}}
    print("REFERENCE " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    line = [x for x in done.stdout.splitlines()
            if x.startswith("REFERENCE ")]
    assert line, done.stderr[-3000:]
    return json.loads(line[0][len("REFERENCE "):])


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_reduced_config_and_unit_counts_match_reference(arch, reference):
    cfg = configs.get_config(arch)
    want = reference[arch]
    assert list(dryrun.unit_counts(cfg)) == want["units"]
    for units, ref in zip((1, 2), want["reduced"]):
        assert dataclasses.asdict(dryrun.reduced_config(cfg, units)) == ref
    for name, multi in (("single", False), ("multi", True)):
        assert dryrun._fsdp_needed(
            cfg, make_production_mesh(multi_pod=multi)) == \
            want["fsdp"][name]


def _jmesh(multi):
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi else \
        ((16, 16), ("data", "model"))
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), names)


def _local(shape, spec, mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        parts = int(np.prod([sizes[a] for a in axes]))
        assert dim % parts == 0
        n *= dim // parts
    return n


def _bytes(tree, specs, mesh, itemsize=None) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_local(t.shape, s, mesh)
               * (itemsize or jnp.dtype(t.dtype).itemsize)
               for t, s in zip(leaves, spec_leaves))


def _reference_bytes(arch, shape, multi, fsdp) -> dict:
    """The cell's bytes a device holds, from the reference's specs."""
    cfg = dataclasses.replace(jconfigs.get_config(arch),
                              shard_activations=True)
    mesh = _jmesh(multi)
    params = jax.eval_shape(lambda k: jmodel.init(k, cfg),
                            jax.random.PRNGKey(0))
    out = {"moments": 0, "caches": 0}
    if shape.kind == "train":
        strategy = cfg.train_parallelism
        pspecs = jshard.param_specs(cfg, params, mesh, fsdp=fsdp,
                                    strategy=strategy)
        ospecs = pspecs if strategy == "dp" else jshard.zero1_specs(
            cfg, params, mesh, fsdp=fsdp)
        out["moments"] = 2 * _bytes(params, ospecs, mesh, itemsize=4)
        bspec = jshard.batch_spec(mesh, 1, batch=shape.global_batch,
                                  axes="all" if strategy == "dp" else "data")
        batch = jtrain.input_specs_train(cfg, shape)
        out["batch"] = sum(_local(t.shape, bspec, mesh) * 4
                           for t in batch.values())
    else:
        pspecs = jshard.param_specs(cfg, params, mesh, fsdp=fsdp)
        extra = 2 if cfg.num_codebooks > 1 else 1
        bspec = jshard.batch_spec(mesh, extra, batch=shape.global_batch)
        if shape.kind == "prefill":
            batch = jserve.input_specs_prefill(cfg, shape)
            out["batch"] = _local(batch["tokens"].shape, bspec, mesh) * 4
        else:
            batch = jserve.input_specs_decode(cfg, shape)
            pos = jshard.batch_spec(mesh, 0, batch=shape.global_batch)
            out["batch"] = (_local(batch["tokens"].shape, bspec, mesh)
                            + _local(batch["pos"].shape, pos, mesh)) * 4
            caches = jserve.cache_specs_struct(cfg, shape)
            out["caches"] = _bytes(caches, jshard.cache_specs(
                cfg, caches, mesh, shape.global_batch), mesh)
    out["params"] = _bytes(params, pspecs, mesh)
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cell_bytes_match_reference_specs(arch, reference):
    cfg = configs.get_config(arch)
    for shape in configs.SHAPES:
        if not configs.shape_applicable(cfg, shape)[0]:
            continue
        for name, multi in (("single", False), ("multi", True)):
            rec = dryrun.cell_record(arch, shape,
                                     make_production_mesh(multi_pod=multi),
                                     name)
            assert rec["ok"] and rec["divides"]
            assert rec["fsdp"] == reference[arch]["fsdp"][name]
            want = _reference_bytes(arch, shape, multi, rec["fsdp"])
            assert rec["bytes_per_device"] == want, (shape.name, name)


def test_command_line_writes_cells_incrementally(tmp_path):
    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "rwkv6-7b", "--mesh", "single", "--out",
                 str(out)])
    first = json.loads(out.read_text())
    assert [(r["shape"], r["ok"]) for r in first] == [
        (s.name, True) for s in configs.SHAPES]
    skipped = [r for r in first if "skipped" in r]
    assert skipped == []          # rwkv6 is sub-quadratic: long_500k runs
    dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k", "--out",
                 str(out)])
    second = json.loads(out.read_text())
    assert second[:len(first)] == first
    assert [r["skipped"] for r in second[len(first):]] == [
        configs.shape_applicable(configs.get_config("smollm-360m"),
                                 configs.SHAPES_BY_NAME["long_500k"])[1]] * 2


def test_import_leaves_the_environment_alone():
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    done = subprocess.run(
        [sys.executable, "-c", "import os, repro_torch.launch.dryrun; "
         "print(os.environ.get('XLA_FLAGS'))"], env=env,
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert done.stdout.strip() == "None", done.stderr[-2000:]
