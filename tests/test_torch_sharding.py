"""The port's launch specs (`repro_torch.launch.sharding`, `launch.mesh`)
against the JAX package's, on the CPU.

Every config, at its smoke and its published widths, on the meshes (1, 1),
(2, 2), (2, 4), (16, 16) and (2, 16, 16): `param_specs` (strategy "tp"
with FSDP off and on, strategy "dp") and `zero1_specs` (FSDP off and on)
equal the reference's `PartitionSpec`s leaf for leaf, each port leaf read
in the reference's stacked pytree through `models.model.reference_path`:
the stacked entries of the reference's spec are None and the rest are the
port's spec. The reference's meshes are built from repeated CPU devices
(its specs read only the axis names and sizes), the port's are
`MeshShape`s. Where the reference splits a stacked axis over ranks (it
does on (2, 2) and (2, 4) only: qwen1.5-4b's stacked q/k/v biases under
ZeRO-1, whose 40 layers divide by 2, and llama4-maverick's stacked
shared-expert MLP at full width, which its expert rule reads as an expert
stack and splits over "model" by its 24 pairs), the port raises on that
leaf, which its unstacked layout cannot place, and every other leaf still
equals the reference's. A stacked entry of axes of size 1 splits nothing
and is dropped. `cache_specs`
likewise for every decode shape and for batches that equal a stacked
extent (the reference's "first dim whose extent is the batch" rule reads
the stacked dims). Then `tests/test_sharding.py`'s five properties on the
port, and the spec-to-placement converter.

All comparisons are exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jshard  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import model  # noqa: E402

MESHES = (((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
WIDTHS = ("smoke", "full")
DECODE_SHAPES = tuple((s.global_batch, s.seq_len) for s in configs.SHAPES
                      if s.kind == "decode")


def _ids(val):
    return "x".join(map(str, val)) if isinstance(val, tuple) else str(val)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), names)


@functools.lru_cache(maxsize=None)
def _pair(arch, width):
    """(port cfg, reference cfg, port meta params, reference shapes)."""
    get = configs.get_smoke_config if width == "smoke" else configs.get_config
    jget = (jconfigs.get_smoke_config if width == "smoke"
            else jconfigs.get_config)
    cfg, jcfg = get(arch), jget(arch)
    params = dict(model.init(cfg, generator=torch.Generator(),
                             device="meta").named_parameters())
    jparams = jax.eval_shape(lambda k: jmodel.init(k, jcfg),
                             jax.random.PRNGKey(0))
    return cfg, jcfg, params, jparams


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _splits(entry, sizes) -> bool:
    """Whether a spec entry splits its dim (an axis of size > 1)."""
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    return int(np.prod([sizes[a] for a in axes])) > 1


def _hold(port_fn, ref_specs, names, sizes):
    """Hold `port_fn(names)` to the reference's `ref_specs` tree: where a
    reference spec splits a stacked axis the port raises naming a leaf of
    that group, and on the other names it equals the reference's past the
    stacked entries, leaf for leaf. Returns how many groups raised."""
    stacked, keep = set(), []
    for name in names:
        keys, index = model.reference_path(name)
        ref = tuple(_leaf(ref_specs, keys))
        if any(_splits(e, sizes) for e in ref[:len(index)]):
            stacked.add(keys)
        else:
            keep.append(name)
    if stacked:
        with pytest.raises(ValueError, match="stacked axis"):
            port_fn(names)
    got = port_fn(keep)
    assert set(got) == set(keep)
    for name in keep:
        keys, index = model.reference_path(name)
        ref = tuple(_leaf(ref_specs, keys))
        assert got[name] == ref[len(index):], (name, ref, got[name])
    return len(stacked)


# Groups on which the reference puts a mesh axis on a stacked axis:
# {(arch, width, mesh shape, variant): count}; everywhere else none.
STACKED_SPECS = {
    ("qwen1.5-4b", w, m, v): 3 for w in WIDTHS for m in ((2, 2), (2, 4))
    for v in ("zero1", "zero1_fsdp")}
STACKED_SPECS.update({
    ("llama4-maverick-400b-a17b", "full", m, v): 3 for m in ((2, 2), (2, 4))
    for v in ("tp", "fsdp", "zero1", "zero1_fsdp")})


@pytest.mark.parametrize("mesh_shape,axes", MESHES, ids=_ids)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_and_zero1_specs_match_reference(arch, width, mesh_shape,
                                               axes):
    cfg, jcfg, params, jparams = _pair(arch, width)
    jmesh = _jmesh(mesh_shape, axes)
    mesh = tmesh.MeshShape(axes, mesh_shape)
    variants = {
        "tp": (jshard.param_specs(jcfg, jparams, jmesh),
               lambda n: sharding.param_specs(
                   cfg, {k: params[k] for k in n}, mesh)),
        "fsdp": (jshard.param_specs(jcfg, jparams, jmesh, fsdp=True),
                 lambda n: sharding.param_specs(
                     cfg, {k: params[k] for k in n}, mesh, fsdp=True)),
        "dp": (jshard.param_specs(jcfg, jparams, jmesh, strategy="dp"),
               lambda n: sharding.param_specs(
                   cfg, {k: params[k] for k in n}, mesh, strategy="dp")),
        "zero1": (jshard.zero1_specs(jcfg, jparams, jmesh),
                  lambda n: sharding.zero1_specs(
                      cfg, {k: params[k] for k in n}, mesh)),
        "zero1_fsdp": (jshard.zero1_specs(jcfg, jparams, jmesh, fsdp=True),
                       lambda n: sharding.zero1_specs(
                           cfg, {k: params[k] for k in n}, mesh, fsdp=True)),
    }
    for variant, (ref, port) in variants.items():
        raised = _hold(port, ref, list(params), dict(zip(axes, mesh_shape)))
        assert raised == STACKED_SPECS.get(
            (arch, width, mesh_shape, variant), 0), variant


def test_zero1_shards_the_stacked_per_block_vectors():
    """ZeRO-1 shards the reference's stacked (32, 960) ln2 scale of
    smollm-360m on its 960: the port's (960,) gets the data axis, which
    the rule would skip on a 1-D leaf read alone. rwkv6-7b has seven such
    vector groups a block, deepseek-v2-236b eight."""
    mesh = tmesh.make_production_mesh()
    counts = {}
    for arch in ("smollm-360m", "rwkv6-7b", "deepseek-v2-236b"):
        cfg, _, params, _ = _pair(arch, "full")
        specs = sharding.zero1_specs(cfg, params, mesh)
        vecs = {model.reference_path(n)[0] for n, p in params.items()
                if p.ndim == 1 and model.reference_path(n)[1]
                and specs[n] == ("data",)}
        counts[arch] = len(vecs)
        if arch == "smollm-360m":
            name = "body.blocks.7.ln2.scale"
            assert tuple(params[name].shape) == (960,)
            assert specs[name] == ("data",)
            assert sharding.param_specs(cfg, params, mesh)[name] == (None,)
    assert counts == {"smollm-360m": 2, "rwkv6-7b": 7,
                      "deepseek-v2-236b": 8}


def _flat(node, keys=(), index=()):
    """(reference keys, stacked index, leaf) of the port's caches."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, keys + (k,), index)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flat(v, keys, index + (i,))
    else:
        yield keys, index, node


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_match_reference(arch, width):
    """Every decode shape and, at smoke widths, batches of 2 and of the
    layer count (equal to a stacked extent): where the reference's batch
    rule lands on a stacked axis the port raises."""
    cfg, jcfg, _, _ = _pair(arch, width)
    cases = list(DECODE_SHAPES)
    if width == "smoke":
        cases += [(2, 64), (cfg.num_layers, 64)]
    raised = set()
    for batch, seq in cases:
        jcaches = jax.eval_shape(lambda: jmodel.init_caches(
            jcfg, batch, seq, jnp.bfloat16))
        caches = model.init_caches(cfg, batch, seq, torch.bfloat16,
                                   device="meta")
        for mesh_shape, axes in MESHES:
            ref = jshard.cache_specs(jcfg, jcaches,
                                     _jmesh(mesh_shape, axes), batch)
            mesh = tmesh.MeshShape(axes, mesh_shape)
            leaves = list(_flat(caches))
            sizes = dict(zip(axes, mesh_shape))
            on_stack = [k for k, i, _ in leaves if any(
                _splits(e, sizes) for e in tuple(_leaf(ref, k))[:len(i)])]
            if on_stack:
                with pytest.raises(ValueError, match="stacked axis"):
                    sharding.cache_specs(cfg, caches, mesh, batch)
                raised.add((batch, mesh_shape))
                continue
            got = dict(((k, i), s) for k, i, s in _flat(
                sharding.cache_specs(cfg, caches, mesh, batch)))
            for keys, index, _ in leaves:
                r = tuple(_leaf(ref, keys))
                assert got[keys, index] == r[len(index):], (keys, r)
    want = set()
    if arch == "rwkv6-7b" and width == "smoke":
        want = {(2, (2, 2)), (2, (2, 4))}
    if arch == "zamba2-1.2b" and width == "smoke":
        want = {(2, (2, 2)), (2, (2, 4))}
    assert raised == want


# -- tests/test_sharding.py's properties, on the port -----------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_divisible_everywhere(arch):
    """On the (1, 1) mesh and the production meshes, each spec divides
    its leaf (`local_numel` raises where one does not)."""
    cfg, _, params, _ = _pair(arch, "smoke")
    for mesh_shape, axes in (MESHES[0],) + MESHES[3:]:
        mesh = tmesh.MeshShape(axes, mesh_shape)
        for fn in (sharding.param_specs, sharding.zero1_specs):
            for n, spec in fn(cfg, params, mesh).items():
                sharding.local_numel(params[n].shape, spec, mesh)


def test_tp_patterns_on_big_mesh():
    cfg, _, params, _ = _pair("deepseek-v2-236b", "smoke")
    specs = sharding.param_specs(cfg, params, tmesh.make_production_mesh())
    assert specs["embed.table"] == ("model", None)
    # the experts (E=8, d, ff): 8 % 16 != 0, so E stays whole
    assert specs["body.moe_blocks.0.moe.w_gate"][0] is None
    assert specs["body.moe_blocks.0.attn.w_uk"][-1] in ("model", None)


def test_fsdp_adds_data_axis():
    """A stack of four (4096, 4096) leaves trips the FSDP threshold."""
    cfg = configs.get_smoke_config("yi-6b")
    params = {f"body.blocks.{i}.mlp.w_gate": (4096, 4096) for i in range(4)}
    specs = sharding.param_specs(cfg, params, tmesh.MeshShape(
        ("data", "model"), (2, 2)), fsdp=True)
    assert all("data" in str(s) for s in specs.values())


def test_zero1_no_duplicate_axes():
    cfg, _, params, _ = _pair("yi-6b", "smoke")
    specs = sharding.zero1_specs(cfg, params, tmesh.MeshShape(
        ("data", "model"), (2, 2)), fsdp=True)
    for spec in specs.values():
        axes = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        assert len(axes) == len(set(axes))


def test_batch_spec_divisibility():
    mesh = tmesh.MeshShape(("data", "model"), (2, 2))
    assert sharding.batch_spec(mesh, 1, batch=4)[0] == "data"
    assert sharding.batch_spec(mesh, 1, batch=1)[0] is None
    big = tmesh.make_production_mesh(multi_pod=True)
    assert sharding.batch_spec(big, 1, batch=64) == (("pod", "data"), None)
    assert sharding.batch_spec(big, 1, batch=16) == ("data", None)
    assert sharding.batch_spec(big, 2, batch=512, axes="all") == (
        ("pod", "data", "model"), None, None)


@pytest.mark.parametrize("batch,extra,axes", [
    (4, 1, "data"), (1, 1, "data"), (64, 2, "data"), (16, 0, "data"),
    (512, 1, "all"), (3, 1, "all")])
@pytest.mark.parametrize("mesh_shape,mesh_axes", MESHES, ids=_ids)
def test_batch_spec_matches_reference(batch, extra, axes, mesh_shape,
                                      mesh_axes):
    ref = jshard.batch_spec(_jmesh(mesh_shape, mesh_axes), extra,
                            batch=batch, axes=axes)
    assert sharding.batch_spec(tmesh.MeshShape(mesh_axes, mesh_shape),
                               extra, batch=batch, axes=axes) == tuple(ref)


# -- meshes and placements ---------------------------------------------------

def test_production_meshes_are_the_references_shapes():
    assert tmesh.make_production_mesh() == tmesh.MeshShape(
        ("data", "model"), (16, 16))
    big = tmesh.make_production_mesh(multi_pod=True)
    assert (big.axis_names, big.shape) == (("pod", "data", "model"),
                                           (2, 16, 16))
    assert tmesh.data_axes(big) == ("pod", "data")
    assert tmesh.model_axis(big) == "model"
    assert tmesh.axis_size(big, "pod") == 2


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    big = tmesh.make_production_mesh(multi_pod=True)
    assert sharding.placements((("pod", "data"), None, "model"), big) == [
        Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, None), big) == [Replicate()] * 3
    for bad in ((("data", "pod"),), ("data", "data"), ("rows",)):
        with pytest.raises(ValueError):
            sharding.placements(bad, big)


def test_make_test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_test_mesh((1, 1), device_type="cpu")
