"""Checkpoints and the restartable training loop of the port, on the CPU:
`CheckpointManager` writes the JAX package's format (each package restores
what the other wrote, with equal arrays and an equal manifest skeleton),
keeps k, cleans stale staging directories and saves asynchronously;
`HeartbeatMonitor` and `TrainLoop` as tests/test_fault.py holds the
reference's, and `TrainLoop` over the port's train step restarting into
the same weights as an uninterrupted run.

Checkpoints hold exact copies, so every comparison here is exact.
"""
import contextlib
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import DeterministicSource  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.fault import (HeartbeatConfig,  # noqa: E402
                                      HeartbeatMonitor, LoopConfig,
                                      RestartRequired, TrainLoop)
from repro_torch.models import model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ("smollm-360m", "musicgen-medium", "llama4-maverick-400b-a17b")


def _pair(arch, dtype="float32"):
    return (dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype=dtype))


def _trained(arch, dtype="float32", steps=2):
    """The port's model (the reference's init) and its AdamW state after
    `steps` train steps, so the moments are not zero."""
    cfg, jcfg = _pair(arch, dtype)
    arrays = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  jcfg))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    o = adamw.init(m)
    step = train.make_train_step(cfg)
    shape = (2, 8, cfg.num_codebooks) if cfg.num_codebooks > 1 else (2, 8)
    for i in range(steps):
        rng = np.random.default_rng(i)
        batch = {k: rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
                 for k in ("tokens", "labels")}
        m, o, _ = step(m, o, batch)
    return cfg, jcfg, m, o


def _assert_same_model(a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    for n in pa:
        assert pa[n].dtype == pb[n].dtype and torch.equal(pa[n], pb[n]), n


def _assert_same_state(a, b):
    assert int(a.step) == int(b.step)
    for x, y in ((a.mu, b.mu), (a.nu, b.nu)):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[n], y[n]) for n in x)


def _jnp(a):
    """A host array as a jnp array, raw bf16 words (``|V2``) as bf16."""
    a = np.asarray(a)
    return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.dtype("V2")
                       else a)


def _ref_state(m, o):
    """The port's state as the reference's (params, AdamWState) of jnp
    arrays."""
    return (jax.tree.map(_jnp, model.params_to_reference(m)),
            jadamw.AdamWState(jnp.asarray(np.asarray(o.step)),
                              jax.tree.map(_jnp, model.to_reference(o.mu)),
                              jax.tree.map(_jnp, model.to_reference(o.nu))))


def _bits(a):
    """An array's raw 2-byte words if it holds bf16 (as bf16 or ``|V2``)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_restores_the_same_tensors(arch, dtype, tmp_path):
    cfg, _, m, o = _trained(arch, dtype)
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(7, m, o, extra={"data_seed": 42})
    m2, o2, step, extra = CheckpointManager(tmp_path, cfg=cfg,
                                            device="cpu").restore()
    assert step == 7 and extra == {"data_seed": 42}
    assert m2.cfg == cfg
    _assert_same_model(m, m2)
    _assert_same_state(o, o2)
    # the manager that saved the model knows its config
    m3, _, _, _ = mgr.restore()
    _assert_same_model(m, m3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(arch, dtype, tmp_path):
    """What the port writes, the reference restores: equal arrays (bf16 as
    the same 2-byte words the reference writes), and the manifest the
    reference writes for the same state has the same skeleton."""
    _, _, m, o = _trained(arch, dtype)
    CheckpointManager(tmp_path / "port", device="cpu").save(3, m, o)
    params, opt, step, _ = JManager(tmp_path / "port").restore()
    want_p, want_o = _ref_state(m, o)
    assert step == 3 and isinstance(opt, jadamw.AdamWState)
    got = jax.tree.leaves((params, opt))
    want = jax.tree.leaves((want_p, want_o))
    assert len(got) == len(want)
    assert jax.tree.structure((params, opt)) == jax.tree.structure(
        (want_p, want_o))
    for a, b in zip(got, want):
        assert np.asarray(a).shape == np.asarray(b).shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    JManager(tmp_path / "ref").save(3, want_p, want_o)
    manifests = [json.loads((tmp_path / d / "step_0000000003" /
                             "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(arch, dtype, tmp_path):
    cfg, _, m, o = _trained(arch, dtype)
    JManager(tmp_path).save(5, *_ref_state(m, o), extra={"k": 1})
    m2, o2, step, extra = CheckpointManager(tmp_path, cfg=cfg,
                                            device="cpu").restore()
    assert step == 5 and extra == {"k": 1}
    _assert_same_model(m, m2)
    _assert_same_state(o, o2)


def test_reference_init_order_checkpoint_restores_in_the_port(tmp_path):
    """The reference's ``model.init`` dict lists its keys unsorted
    (embed, body, ln_f, head); its leaves still lie in sorted order."""
    cfg, jcfg = _pair("musicgen-medium")
    params = jmodel.init(jax.random.PRNGKey(1), jcfg)
    JManager(tmp_path).save(1, params)
    m, opt, _, _ = CheckpointManager(tmp_path, cfg=cfg,
                                     device="cpu").restore()
    assert opt is None
    _assert_same_model(m, model.params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))


def _params():
    return {"layer": {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
                      "b": np.ones(4, np.float32)}}


def test_tree_round_trip_without_a_config(tmp_path):
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(7, _params(), None, extra={"data_seed": 42})
    p2, o2, step, extra = mgr.restore()
    assert step == 7 and extra["data_seed"] == 42 and o2 is None
    np.testing.assert_array_equal(p2["layer"]["w"].numpy(),
                                  _params()["layer"]["w"])
    # and the reference reads the same tree
    jp, _, _, _ = JManager(tmp_path).restore()
    np.testing.assert_array_equal(np.asarray(jp["layer"]["b"]),
                                  _params()["layer"]["b"])


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        mgr.save(s, _params())
    assert mgr.all_steps() == [3, 4]


def test_stale_tmp_cleanup(tmp_path):
    (tmp_path / "tmp.0000000009.0").mkdir()
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, _params())
    assert not list(pathlib.Path(tmp_path).glob("tmp.*"))


def test_async_save_then_restore(tmp_path):
    cfg, _, m, o = _trained("smollm-360m")
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save_async(3, m, o)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    with torch.no_grad():                 # the next step changes the model
        for p in m.parameters():
            p.add_(1.0)
    m2, _, step, _ = mgr.restore()        # restore waits for the writer
    assert step == 3
    assert all(torch.equal(p, before[n]) for n, p in m2.named_parameters())


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5, device="cpu")
    for s in (1, 2, 3):
        mgr.save(s, {"layer": {"b": np.full(4, float(s), np.float32)}})
    p2, _, step, _ = mgr.restore(step=2)
    assert step == 2
    np.testing.assert_allclose(p2["layer"]["b"].numpy(), 2.0)
    assert mgr.latest_step() == 3


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path, device="cpu").restore()


@contextlib.contextmanager
def _one_rank_mesh(root):
    """A (1, 1) ("data", "model") DeviceMesh of one gloo rank on the CPU."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / "store"), 1), rank=0, world_size=1)
    try:
        yield make_test_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_restore_waits_for_the_mesh_slice(tmp_path):
    """The port's counterpart of tests/test_ckpt.py's elastic restore
    onto a mesh: a saved tree and a saved model restored onto a one-rank
    (1, 1) DeviceMesh come back as DTensors whose full tensors are the
    plain restore's and the reference's restore onto its
    `make_test_mesh((1, 1))`, bit for bit."""
    from jax.sharding import PartitionSpec as P
    from repro.launch import sharding as jshard
    from repro.launch.mesh import make_test_mesh as jmesh
    from repro_torch.launch import sharding
    from torch.distributed.tensor import DTensor

    tree_dir, model_dir = tmp_path / "tree", tmp_path / "model"
    CheckpointManager(tree_dir, device="cpu").save(1, _params())
    cfg, jcfg, m, _ = _trained("smollm-360m", steps=1)
    CheckpointManager(model_dir, device="cpu").save(1, m)
    want, _, _, _ = JManager(tree_dir).restore(
        mesh=jmesh((1, 1)), specs={"layer": {"w": P(None, None),
                                             "b": P(None)}})
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                   jcfg))
    jspecs = jshard.param_specs(jcfg, jparams, jmesh((1, 1)))
    jwant, _, _, _ = JManager(model_dir).restore(mesh=jmesh((1, 1)),
                                                 specs=jspecs)
    plain, _, _, _ = CheckpointManager(model_dir, cfg=cfg,
                                       device="cpu").restore()
    with _one_rank_mesh(tmp_path) as mesh:
        got, _, _, _ = CheckpointManager(tree_dir, device="cpu").restore(
            mesh=mesh, specs={"layer": {"w": (None, None), "b": (None,)}})
        for k in ("w", "b"):
            assert isinstance(got["layer"][k], DTensor)
            np.testing.assert_array_equal(
                got["layer"][k].full_tensor().numpy(),
                np.asarray(want["layer"][k]))
        specs = sharding.param_specs(cfg, m, mesh)
        m2, _, _, _ = CheckpointManager(model_dir, cfg=cfg).restore(
            mesh=mesh, specs=specs)
        plain_named = dict(plain.named_parameters())
        for name, p in m2.named_parameters():
            assert isinstance(p.data, DTensor), name
            full = p.full_tensor()
            assert torch.equal(full, plain_named[name]), name
            keys, index = model.reference_path(name)
            ref = jwant
            for key in keys:
                ref = ref[key]
            np.testing.assert_array_equal(
                full.numpy(), np.asarray(ref)[index])
        with pytest.raises(ValueError, match="both"):
            CheckpointManager(model_dir, cfg=cfg).restore(mesh=mesh)


def test_restore_without_a_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _params())
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore()


# -- the loop ----------------------------------------------------------------------

def test_monitor_flags_missing_heartbeat():
    mon = HeartbeatMonitor(3, HeartbeatConfig(deadline_s=10))
    now = 1000.0
    for w in range(3):
        mon.report(w, 1.0, now=now)
    assert mon.dead_workers(now=now + 5) == []
    mon.report(0, 1.0, now=now + 20)
    mon.report(1, 1.0, now=now + 20)
    assert mon.dead_workers(now=now + 20) == [2]


def test_monitor_flags_straggler():
    mon = HeartbeatMonitor(4, HeartbeatConfig(min_history=4,
                                              straggler_mad_k=5.0))
    for _ in range(8):
        for w in range(3):
            mon.report(w, 1.0 + 0.01 * w)
        mon.report(3, 30.0)
    assert mon.stragglers() == [3]


def test_train_loop_restarts_and_completes(tmp_path):
    """A failure mid-run: the loop restores the last checkpoint (step 6)
    and replays the deterministic stream from there."""
    ckpt = CheckpointManager(tmp_path, device="cpu")
    seen = []
    fail_once = {"armed": True}

    def step_fn(params, opt, batch):
        step_id = int(batch["x"][0])
        if fail_once["armed"] and step_id == 7:
            fail_once["armed"] = False
            raise RestartRequired("injected failure")
        seen.append(step_id)
        return params + 1, opt, {"loss": 0.0}

    src = DeterministicSource(
        lambda rng, step: {"x": np.full(2, step)}, seed=0)
    loop = TrainLoop(step_fn, src, ckpt,
                     LoopConfig(total_steps=10, ckpt_every=2))
    ckpt.save(0, np.asarray(0.0), None)
    params, _, step = loop.run(np.asarray(0.0), None, start_step=0)
    assert step == 10
    assert loop.restarts == 1
    assert seen == [0, 1, 2, 3, 4, 5, 6, 6, 7, 8, 9]
    assert float(params) == 10.0


def test_loop_gives_up_after_max_restarts(tmp_path):
    ckpt = CheckpointManager(tmp_path, device="cpu")
    ckpt.save(0, np.asarray(0.0), None)

    def always_fail(params, opt, batch):
        raise RestartRequired("down")

    src = DeterministicSource(lambda rng, step: {"x": np.zeros(1)}, seed=0)
    loop = TrainLoop(always_fail, src, ckpt,
                     LoopConfig(total_steps=5, max_restarts=2))
    with pytest.raises(RestartRequired):
        loop.run(np.asarray(0.0), None)
    assert loop.restarts == 3


def test_train_loop_over_the_train_step_restarts_into_the_same_weights(
        tmp_path):
    """Six steps of the port's train step on `lm_batches` through
    `TrainLoop`, once straight and once failing at step 4 (restored from
    step 3's checkpoint): the same bits."""
    cfg, jcfg = _pair("smollm-360m")
    arrays = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  jcfg))

    class Batches:
        def iter_from(self, start):
            return lm_batches(5, 6, 2, 8, cfg.vocab_size, start_step=start)

    runs = []
    for fail_at in (None, 4):
        step = train.make_train_step(cfg)
        armed = {"on": fail_at is not None}
        calls = []

        def step_fn(m, o, batch, step=step, armed=armed, calls=calls):
            calls.append(1)
            if armed["on"] and len(calls) == fail_at + 1:
                armed["on"] = False
                raise RestartRequired("injected")
            return step(m, o, batch)

        m = model.params_from_reference(arrays, cfg, device="cpu")
        ckpt = CheckpointManager(tmp_path / str(fail_at), device="cpu")
        ckpt.save(0, m, adamw.init(m))
        loop = TrainLoop(step_fn, Batches(), ckpt,
                         LoopConfig(total_steps=6, ckpt_every=3))
        m, o, n = loop.run(m, adamw.init(m))
        assert n == 6 and loop.restarts == (fail_at is not None)
        runs.append((m, o))
    _assert_same_model(runs[0][0], runs[1][0])
    _assert_same_state(runs[0][1], runs[1][1])
