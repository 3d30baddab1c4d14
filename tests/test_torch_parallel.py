"""The port's parallel paths on 8 gloo CPU ranks as a (2, 4) ("data",
"model") DeviceMesh, against the JAX package's own parallel functions on
the same layout (8 host devices in a subprocess, as
tests/test_parallel_paths.py runs them) and against the dense paths.

Each rank holds the whole inputs of its data shard, as the port's models
hold their activations: rows [2d, 2d + 2) of a batch of 4 for data
coordinate d. Under `meshctx.mesh_context(mesh)`:

* `attention.context_parallel_attention` (B 2, S 1024, H 6, KV 2, dh 64;
  data shard of one row): each model rank launches attention once on its
  256 query rows against keys [0, 256 (r + 1)), and an all-gather over the
  model group rebuilds the rows;
* `moe.moe_apply` expert-parallel: deepseek-v2's smoke config with 8
  experts (2 a model rank), the reference's `init_moe` weights, x of (4,
  16, d), its local capacity, one all-reduce of the partial outputs, the
  aux loss averaged over "data";
* `layers.matmul_rowparallel`: x (4, 16, 256) @ w (256, 128), each model
  rank its 64 rows of w and columns of x, one all-reduce;
* the model's own wiring: a (2, 512) prefill of each data shard with
  ``shard_activations`` on yi-6b's smoke config (dense) and deepseek-v2's
  (MLA and the MoE), whose attention, wo, MLP down projections and MoE
  reach their parallel forms inside the model, against the same prefill
  with no mesh (float32, the port's bar on logits: 2e-5 abs + rel,
  `tests/test_torch_models.py`'s), with each collective counted;
* `CheckpointManager.restore(mesh=, specs=)` of a smoke model (yi-6b's,
  vocab 1024) under three sets of specs: `param_specs` (tp), `zero1_specs`
  (a data and a model split on two dims, and the 1-D norm scales over
  "data") and `param_specs(strategy="dp")` (a dim split over ("data",
  "model") at once): each rank's block against the whole tensor cut at its
  mesh coordinate, and ``full_tensor()`` against the plain restore, bit
  for bit.

Float32 throughout. Bars: against the reference's parallel functions, the
port's float32 bars (2e-5: `tests/test_torch_moe.py`'s on the MoE's output
and aux, `tests/test_torch_mla.py`'s on attention against the reference's
`chunked_causal_attention`); against the dense paths, the reference's own
bars (tests/test_parallel_paths.py): 1e-4 for attention, 0.05 for the
MoE's output (its capacity drops depend on the layout) and 1e-3 for its
aux loss. Every spawn and the subprocess have a time limit.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import attention, layers, meshctx, moe  # noqa: E402
from repro_torch.models import model as modellib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (2, 4)
WORLD = 8
SPAWN_TIMEOUT_S = 240
REF_TIMEOUT_S = 600
F32_TOL = 2e-5
LOGITS_TOL = dict(atol=2e-5, rtol=2e-5)
PREFILL_ARCHS = ("yi-6b", "deepseek-v2-236b")
PREFILL_TOKENS = (4, 512)
RESTORE_VOCAB = 1024
CP_DENSE_TOL = 1e-4
MOE_DENSE_TOL = 0.05
AUX_DENSE_TOL = 1e-3

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, "src")
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.launch.mesh import _make_mesh
    from repro.models import attention, layers, meshctx, moe

    out_dir = sys.argv[1]
    inp = dict(np.load(out_dir + "/inputs.npz"))
    mesh = _make_mesh((2, 4), ("data", "model"))
    q, k, v = (jnp.asarray(inp[n]) for n in ("q", "k", "v"))
    with meshctx.mesh_context(mesh):
        cp = jax.jit(lambda q, k, v: attention.context_parallel_attention(
            q, k, v, m_size=4, kv_chunk=256))(q, k, v)
    dense = attention.chunked_causal_attention(q, k, v, q_chunk=256,
                                               kv_chunk=256)

    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"),
                              num_experts=8, shard_activations=True,
                              dtype="float32")
    p = moe.init_moe(jax.random.PRNGKey(1), cfg)
    x = jnp.asarray(inp["x_moe"])
    with meshctx.mesh_context(mesh):
        out_ep, aux_ep = jax.jit(lambda p, x: moe.moe_apply(p, cfg, x))(p, x)
    cfg_d = dataclasses.replace(cfg, shard_activations=False)
    out_d, aux_d = moe.moe_apply(p, cfg_d, x)

    xr, wr = jnp.asarray(inp["x_row"]), jnp.asarray(inp["w_row"])
    with meshctx.mesh_context(mesh):
        row = jax.jit(
            lambda x, w: layers.matmul_rowparallel(x, w, cfg),
            in_shardings=(NamedSharding(mesh, P("data", None, "model")),
                          NamedSharding(mesh, P("model", None))),
            out_shardings=NamedSharding(mesh, P("data", None, None)))(xr, wr)
    weights = {k: np.asarray(v) for k, v in p.items() if k != "shared"}
    weights.update({"shared_" + k: np.asarray(v)
                    for k, v in p["shared"].items()})
    np.savez(out_dir + "/reference.npz", cp=np.asarray(cp),
             dense=np.asarray(dense), out_ep=np.asarray(out_ep),
             aux_ep=np.asarray(aux_ep), out_d=np.asarray(out_d),
             aux_d=np.asarray(aux_d), row=np.asarray(row),
             **{"w_" + k: v for k, v in weights.items()})
    print("REFERENCE_OK")
""")


def _cfg():
    return dataclasses.replace(configs.get_smoke_config("deepseek-v2-236b"),
                               num_experts=8, shard_activations=True,
                               dtype="float32")


def _moe_params(ref) -> torch.nn.Module:
    """The reference's `init_moe` weights as the port's MoE module."""
    t = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files
         if k.startswith("w_")}
    shared = layers.params(**{k[7:]: v for k, v in t.items()
                              if k.startswith("shared_")})
    return layers.params(shared=shared, **{
        k: v for k, v in t.items() if not k.startswith("shared_")})


def _prefill_cfg(arch: str):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               shard_activations=True)


def _prefill_model(arch: str):
    return modellib.init(_prefill_cfg(arch), generator=torch.Generator()
                         .manual_seed(3), device="cpu")


def _restore_cfg():
    return dataclasses.replace(configs.get_smoke_config("yi-6b"),
                               vocab_size=RESTORE_VOCAB)


def _restore_specs(model, mesh) -> dict:
    cfg = _restore_cfg()
    return {"tp": sharding.param_specs(cfg, model, mesh),
            "zero1": sharding.zero1_specs(cfg, model, mesh),
            "dp": sharding.param_specs(cfg, model, mesh, strategy="dp")}


def _rank(rank: int, root: str) -> None:
    """One gloo rank of the (2, 4) mesh: the three parallel paths, the
    model prefills on its data shard and the restores onto the mesh,
    saved to ``rank<r>.pt``."""
    torch.set_num_threads(1)
    root = pathlib.Path(root)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        mesh = make_test_mesh(MESH, device_type="cpu")
        d = mesh.get_local_rank("data")
        inp = {k: torch.from_numpy(v) for k, v in
               np.load(root / "inputs.npz").items()}
        ref = np.load(root / "reference.npz")
        cfg = _cfg()
        p = _moe_params(ref)
        half = slice(d, d + 1)
        shard = slice(2 * d, 2 * d + 2)
        calls = []
        for name in ("all_reduce", "all_gather"):
            def spy(*a, _fn=getattr(dist, name), _name=name, **kw):
                calls.append(_name)
                return _fn(*a, **kw)
            setattr(dist, name, spy)
        with meshctx.mesh_context(mesh):
            cp = attention.context_parallel_attention(
                inp["q"][half], inp["k"][half], inp["v"][half], m_size=4)
            n_cp = len(calls)
            out, aux = moe.moe_apply(p, cfg, inp["x_moe"][shard])
            n_ep = len(calls)
            row = layers.matmul_rowparallel(inp["x_row"][shard],
                                            inp["w_row"], cfg)
        collectives = (calls[:n_cp], calls[n_cp:n_ep], calls[n_ep:])
        prefill = {}
        for arch in PREFILL_ARCHS:
            model = _prefill_model(arch)
            del calls[:]
            with meshctx.mesh_context(mesh):
                logits = modellib.apply_train(model, inp["tokens"][shard])
            prefill[arch] = (logits, list(calls))
        mgr = CheckpointManager(root / "ckpt", cfg=_restore_cfg(),
                                device="cpu")
        plain, _, _, _ = mgr.restore()
        restores = {}
        for how, specs in _restore_specs(plain, mesh).items():
            on_mesh, _, _, _ = mgr.restore(mesh=mesh, specs=specs)
            restores[how] = {
                name: (p.to_local().clone(), p.full_tensor())
                for name, p in on_mesh.named_parameters()}
        torch.save({"cp": cp, "out": out, "aux": aux, "row": row,
                    "data": d, "model": mesh.get_local_rank("model"),
                    "collectives": collectives, "prefill": prefill,
                    "restores": restores}, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(root: pathlib.Path) -> None:
    ctx = tmp.start_processes(_rank, args=(str(root),), nprocs=WORLD,
                              join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} gloo ranks did not end in "
                        f"{SPAWN_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and each port rank's, from one subprocess
    and one spawn."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    d_model = _cfg().d_model
    np.savez(root / "inputs.npz",
             q=rng.standard_normal((2, 1024, 6, 64), np.float32),
             k=rng.standard_normal((2, 1024, 2, 64), np.float32),
             v=rng.standard_normal((2, 1024, 2, 64), np.float32),
             x_moe=(rng.standard_normal((4, 16, d_model), np.float32)
                    * np.float32(0.1)),
             x_row=rng.standard_normal((4, 16, 256), np.float32),
             w_row=rng.standard_normal((256, 128), np.float32)
             / np.float32(16),
             tokens=rng.integers(0, configs.get_smoke_config(
                 PREFILL_ARCHS[0]).vocab_size, PREFILL_TOKENS))
    CheckpointManager(root / "ckpt", cfg=_restore_cfg(), device="cpu").save(
        1, modellib.init(_restore_cfg(), generator=torch.Generator()
                         .manual_seed(5), device="cpu"))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", _REFERENCE, str(root)],
                          env=env, capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S, cwd=ROOT)
    assert "REFERENCE_OK" in done.stdout, done.stderr[-3000:]
    _spawn(root)
    ranks = [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]
    return (dict(np.load(root / "inputs.npz")),
            np.load(root / "reference.npz"), ranks, root)


def _max(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def test_mesh_coordinates_and_collectives(runs):
    """Rank 4d + m sits at (d, m), and each path ran its parallel form:
    CP one all-gather; EP the partials' all-reduce, the aux loss's over
    "data" and the shared experts' row-parallel down projection's; the
    row-parallel matmul one all-reduce."""
    _, _, ranks, _ = runs
    assert [(r["data"], r["model"]) for r in ranks] == [
        (d, m) for d in range(2) for m in range(4)]
    for r in ranks:
        assert r["collectives"] == (["all_gather"], ["all_reduce"] * 3,
                                    ["all_reduce"])


def test_context_parallel_attention_matches_reference(runs):
    _, ref, ranks, _ = runs
    for r in ranks:
        d = r["data"]
        assert _max(r["cp"], ref["cp"][d:d + 1]) <= F32_TOL
        assert _max(r["cp"], ref["dense"][d:d + 1]) <= CP_DENSE_TOL
        # every model rank of a data group holds the same gathered rows
        assert torch.equal(r["cp"], ranks[4 * d]["cp"])


def test_context_parallel_attention_matches_one_launch(runs):
    """The gathered rows against the port's own attention over all rows,
    on the CPU path (the card's bitwise equality is chip_smoke.py's)."""
    inp, _, ranks, _ = runs
    from repro_torch.kernels.flash_attention.ops import flash_attention
    full = flash_attention(*(torch.from_numpy(inp[n]) for n in "qkv"))
    for r in ranks:
        d = r["data"]
        assert _max(r["cp"], full[d:d + 1]) <= F32_TOL


def test_expert_parallel_moe_matches_reference(runs):
    _, ref, ranks, _ = runs
    for r in ranks:
        rows = slice(2 * r["data"], 2 * r["data"] + 2)
        assert _max(r["out"], ref["out_ep"][rows]) <= F32_TOL
        assert abs(float(r["aux"]) - float(ref["aux_ep"])) <= F32_TOL
        assert _max(r["out"], ref["out_d"][rows]) <= MOE_DENSE_TOL
        assert abs(float(r["aux"]) - float(ref["aux_d"])) <= AUX_DENSE_TOL


def test_expert_parallel_moe_matches_the_ports_dense_path(runs):
    """Each data shard's EP output against the port's dense `moe_apply`
    on that shard alone (the same local capacity, so the same kept
    assignments), and the aux loss against the dense aux averaged over
    the shards."""
    inp, ref, ranks, _ = runs
    cfg = dataclasses.replace(_cfg(), shard_activations=False)
    p = _moe_params(ref)
    x = torch.from_numpy(inp["x_moe"])
    dense = [moe.moe_apply(p, cfg, x[2 * d:2 * d + 2]) for d in range(2)]
    aux = (dense[0][1] + dense[1][1]) / 2
    for r in ranks:
        out_d, _ = dense[r["data"]]
        assert _max(r["out"], out_d) <= F32_TOL
        assert abs(float(r["aux"]) - float(aux)) <= F32_TOL


def test_row_parallel_matmul_matches_reference(runs):
    inp, ref, ranks, _ = runs
    whole = inp["x_row"].astype(np.float64) @ inp["w_row"]
    for r in ranks:
        rows = slice(2 * r["data"], 2 * r["data"] + 2)
        assert _max(r["row"], ref["row"][rows]) <= F32_TOL
        assert _max(r["row"], whole[rows]) <= F32_TOL


# The collectives of each prefill on the (2, 4) mesh, layer by layer:
# context-parallel attention's all-gather, wo's all-reduce, then the dense
# MLP's down projection's all-reduce, or the MoE's three (the partial
# outputs, the aux loss over "data", the shared experts' down projection).
_DENSE_LAYER = ["all_gather", "all_reduce", "all_reduce"]
PREFILL_COLLECTIVES = {
    "yi-6b": _DENSE_LAYER * 2,
    "deepseek-v2-236b": _DENSE_LAYER + ["all_gather"] + ["all_reduce"] * 4,
}


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_under_the_mesh_matches_the_prefill_without_one(runs, arch):
    """Each rank's logits of its data shard, from the model's parallel
    wiring under the (2, 4) mesh, against the same shard's prefill with no
    mesh in this process, at the port's float32 bar."""
    inp, _, ranks, _ = runs
    model = _prefill_model(arch)
    tokens = torch.from_numpy(inp["tokens"])
    want = [modellib.apply_train(model, tokens[2 * d:2 * d + 2])
            for d in range(2)]
    for r in ranks:
        logits, calls = r["prefill"][arch]
        assert calls == PREFILL_COLLECTIVES[arch]
        assert logits.shape == want[r["data"]].shape
        torch.testing.assert_close(logits, want[r["data"]], **LOGITS_TOL)


def _block(t, spec, coord: dict):
    """The block of the whole tensor `t` that mesh coordinate `coord`
    holds under `spec`: on each dim, the block whose index is the
    coordinates of the dim's axes read as one number, the first axis the
    most significant, of as many blocks as those axes have ranks."""
    sizes = dict(zip(("data", "model"), MESH))
    for dim, entry in enumerate(spec):
        index, count = 0, 1
        for a in () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,)):
            index, count = index * sizes[a] + coord[a], count * sizes[a]
        step = t.shape[dim] // count
        t = t.narrow(dim, index * step, step)
    return t


# Entries each set of specs holds at this size: tp splits over "model"
# only; ZeRO-1 adds "data" (on a second dim, or alone on a norm scale);
# dp splits one dim over both axes at once.
SPLITS = {"tp": {"model"}, "zero1": {"model", "data"},
          "dp": {("data", "model")}}


@pytest.mark.parametrize("how", tuple(SPLITS))
def test_restore_onto_the_mesh_places_each_block(runs, how):
    """Each rank's block of each parameter is the plain restore's tensor
    cut at the rank's mesh coordinate by its spec, and its full tensor is
    the plain restore's, bit for bit. The specs hold the entries of
    `SPLITS`."""
    _, _, ranks, root = runs
    plain, _, _, _ = CheckpointManager(root / "ckpt", cfg=_restore_cfg(),
                                       device="cpu").restore()
    want = dict(plain.named_parameters())
    specs = _restore_specs(plain, type("M", (), {
        "axis_names": ("data", "model"), "shape": MESH})())[how]
    assert SPLITS[how] <= {e for spec in specs.values() for e in spec}
    for r in ranks:
        coord = {"data": r["data"], "model": r["model"]}
        got = r["restores"][how]
        assert set(got) == set(want)
        for name, (local, full) in got.items():
            assert torch.equal(full, want[name]), name
            assert torch.equal(local, _block(want[name], specs[name],
                                             coord)), name


def test_paths_stay_dense_without_a_mesh():
    """No mesh, or a mesh whose model axis is 1: the dense paths, the
    same bits as calling them directly."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    assert torch.equal(layers.matmul_rowparallel(x, w, cfg), x @ w)
    shape = meshctx.axis_sizes(type("M", (), {
        "axis_names": ("data", "model"), "shape": (4, 1)})())
    assert shape == {"data": 4, "model": 1}
    assert meshctx.model_size(None) == 1
    with pytest.raises(TypeError, match="DeviceMesh"):
        meshctx.model_group(configs.SHAPES)
