"""The port's trainer against the JAX package, on the CPU: the loss, every
gradient leaf, activation checkpointing, AdamW, the train step with and
without accumulation, ``lm_batches`` and gradient compression, for the
dense, MoE, hybrid Mamba2 and RWKV6 families.

The reference's ``model.init(PRNGKey(0), cfg)`` weights (biases and norm
scales perturbed with seeded noise, so that they are exercised) are
carried across by `params_from_reference`; tokens, labels and gradients
come from numpy seeds. Float32 throughout. Tolerances:
* loss, ce, aux, grad_norm, lr: rtol 2e-6 (a few float32 ulps);
* every gradient leaf: |port - ref| <= 2e-5 · max|ref| of the leaf, the
  port's logits bar (tests/test_torch_models.py); the largest reading over
  the six configs is 1.25e-6 (deepseek-v2's MLA). rwkv6's reference runs
  its scan on its exact recurrence (patched in, as tests/test_torch_rwkv.py
  does): its chunked form's float32 sums move rwkv6's gradient leaves by
  up to 2.3e-5 of their largest value (batch seed 10), the port lies 9e-6
  from the exact recurrence. zamba2 is held against the chunked scan;
* AdamW alone from the same gradients: atol = rtol = 2e-6 (float32
  rounding of the same operations);
* parameters after 3 train steps: every element within lr, and at most
  one in 5000 of them beyond 1e-6. Adam divides each gradient by its own
  scale, so an element whose gradient is rounding noise (|g| near eps)
  may move by up to lr either way in a step. The readings: at most 1.03e-4
  at lr 1e-3 (an attention projection of smollm's smoke model), and at
  most 6 of 147,776 elements (musicgen's) beyond 1e-6; the first moments
  stay within 1e-7. rwkv6's smoke model does not meet these bars even
  against itself: the reference's own eager evaluation
  (``jax.disable_jit``) lies farther from its jitted one, over the same
  three steps with accumulation 1, than they allow: grad_norm 2.84e-5,
  the first moment of u 1.44e-6, 107 of 114,368 parameters beyond 1e-6
  (the port: 1.91e-5, 8.5e-7, 59). Two causes, both in the model: the
  per-head group norm after the scan divides by sqrt(var + eps) over 16
  channels, and at the first token o_0 = (q_0 · u · k_0) v_0 cancels to
  var 2.7e-6 < eps (batch seed 1), so the rounding of o there reaches
  dL/do magnified about 280 times: dL/do lies 1e-6 to 5.3e-5 of its
  largest value from a float64 evaluation over batch seeds 1, 2, 3, 10,
  11 and 12 (at the second block the port's is the nearer in five of
  the six, at the first the farther in all six, by 1.1 to 2.9 times);
  and Adam's g / (|g| + eps) turns the rounding of gradient
  elements near eps into parameter moves of up to 0.24 lr (maa_w2),
  which the next steps carry. So rwkv6's chained steps are held, each
  quantity, to the larger of the bar above and twice the reference's own
  eager-to-jit spread, measured in the run (`reference_spread`).
"""
import contextlib
import dataclasses
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import scan_ops as jscan_ops  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from repro_torch.optim import adamw, grad_compress  # noqa: E402

# smollm's smoke (dense, tied), yi's (GQA), qwen1.5's (QKV bias), musicgen's
# (four codebooks), llama4's (interleaved MoE, sigmoid gate),
# deepseek-v2's (MLA with a dense-prefix MoE, softmax top-k), zamba2's (Mamba2
# blocks and a shared attention block) and rwkv6's (RWKV6 blocks)
ARCHS = ("smollm-360m", "yi-6b", "qwen1.5-4b", "musicgen-medium",
         "llama4-maverick-400b-a17b", "deepseek-v2-236b", "zamba2-1.2b",
         "rwkv6-7b")
SCAN_ARCHS = ("zamba2-1.2b", "rwkv6-7b")
EXACT_SCAN_ARCHS = ("rwkv6-7b",)
SCALAR_RTOL = 2e-6
GRAD_TOL = 2e-5
ADAMW_TOL = dict(atol=2e-6, rtol=2e-6)
STEP_LR = 1e-3
STEP_OPT = dict(lr=STEP_LR, warmup_steps=2, total_steps=10)
SPAWN_TIMEOUT_S = 240


def _pair(arch, **change):
    return (dataclasses.replace(configs.get_smoke_config(arch), **change),
            dataclasses.replace(jconfigs.get_smoke_config(arch), **change))


def _reference_arrays(jcfg, seed=0):
    """The reference's init at PRNGKey(0) as numpy, every bias and norm
    scale perturbed from `seed`."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name in ("bq", "bk", "bv"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "scale":
            return (a * (1 + 0.2 * rng.standard_normal(a.shape))).astype(
                a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, jmodel.init(jax.random.PRNGKey(0), jcfg))


def _batch(cfg, seed, b=4, s=32):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
            for k in ("tokens", "labels")}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a, np.float32))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


def _grads(m, tokens, labels, mask=None):
    """(loss, ce, aux, gradients by parameter name) of the port's
    loss_fn."""
    params = dict(m.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, (ce, aux) = model.loss_fn(m, tokens, labels, mask)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, ce, aux, dict(zip(params, grads))


# -- the loss --------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lead", [(7,), (3, 5)])
def test_softmax_cross_entropy_matches_reference(masked, lead):
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal(lead + (50,))).astype(np.float32)
    labels = rng.integers(0, 50, lead).astype(np.int32)
    mask = (rng.random(lead) < 0.6).astype(np.float32) if masked else None
    want = jlayers.softmax_cross_entropy(jnp.asarray(logits), labels,
                                         None if mask is None else
                                         jnp.asarray(mask))
    got = layers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=SCALAR_RTOL)


def test_softmax_cross_entropy_mask_of_zeros_divides_by_one():
    logits = torch.zeros(2, 3, 4)
    labels = torch.zeros(2, 3, dtype=torch.int64)
    got = layers.softmax_cross_entropy(logits, labels, torch.zeros(2, 3))
    assert float(got) == 0.0


def _exact_scan(q, k, v, w, u=None, initial_state=None, chunk=64):
    """The reference's exact recurrence on w clipped as its chunked scan
    clips it (``scan_ops.py:93``)."""
    return jscan_ops.linear_scan_recurrent(q, k, v, jnp.clip(w, 1e-6, 1.0),
                                           u, initial_state)


def _reference_patch(mp, arch):
    """Put the reference's exact recurrence in place of its chunked scan
    for the archs in EXACT_SCAN_ARCHS."""
    if arch in EXACT_SCAN_ARCHS:
        mp.setattr(jscan_ops, "linear_scan_chunked", _exact_scan)


@pytest.fixture(scope="module")
def reference_grads():
    """``reference_grads(arch)``: the reference's loss, ce, aux and
    gradient on `arch`'s perturbed init and batch seed 1 (rwkv6's scan on
    its exact recurrence); each computed once a module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            _, jcfg = _pair(arch)
            batch = _batch(configs.get_smoke_config(arch), 1)
            with pytest.MonkeyPatch.context() as mp:
                _reference_patch(mp, arch)
                (jl, (jce, jaux)), jg = jax.value_and_grad(
                    lambda p: jmodel.loss_fn(p, jcfg, batch["tokens"],
                                             batch["labels"]),
                    has_aux=True)(jax.tree.map(jnp.asarray,
                                               _reference_arrays(jcfg)))
            cache[arch] = ((float(jl), float(jce), float(jaux)),
                           _leaves(jg))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch, reference_grads):
    """`loss_fn` and its gradient, leaf by leaf in the reference's stacked
    layout, against ``jax.value_and_grad(model.loss_fn)``; rwkv6's against
    the reference on its exact recurrence."""
    cfg, jcfg = _pair(arch)
    arrays = _reference_arrays(jcfg)
    batch = _batch(cfg, 1)
    m = model.params_from_reference(arrays, cfg, device="cpu")
    loss, ce, aux, grads = _grads(m, batch["tokens"], batch["labels"])
    scalars, want = reference_grads(arch)
    for got, w in zip((loss, ce, aux), scalars):
        np.testing.assert_allclose(float(got), w, rtol=SCALAR_RTOL)
    got = _leaves(model.to_reference(grads))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path


def test_masked_loss_gradient_matches_reference():
    cfg, jcfg = _pair("smollm-360m")
    arrays = _reference_arrays(jcfg)
    batch = _batch(cfg, 2)
    mask = (np.random.default_rng(4).random((4, 32)) < 0.5).astype(
        np.float32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch["tokens"], batch["labels"],
                                 jnp.asarray(mask)),
        has_aux=True)(jax.tree.map(jnp.asarray, arrays))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    loss, _, _, grads = _grads(m, batch["tokens"], batch["labels"], mask)
    np.testing.assert_allclose(float(loss), float(jl), rtol=SCALAR_RTOL)
    for (path, g), (_, w) in zip(_leaves(model.to_reference(grads)),
                                 _leaves(jg)):
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium",
                                  "llama4-maverick-400b-a17b",
                                  "zamba2-1.2b", "rwkv6-7b"])
def test_remat_gives_the_same_gradient_bits(arch):
    """``remat="block"`` recomputes each block in the backward; on the CPU
    the loss and every gradient are the same bits as without it."""
    runs = []
    for remat in ("none", "block"):
        cfg, jcfg = _pair(arch, remat=remat)
        m = model.params_from_reference(_reference_arrays(jcfg), cfg,
                                        device="cpu")
        batch = _batch(cfg, 5)
        runs.append(_grads(m, batch["tokens"], batch["labels"]))
    (l0, _, _, g0), (l1, _, _, g1) = runs
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_loss_runs_outside_inference_mode_and_serving_inside_it():
    cfg, jcfg = _pair("smollm-360m")
    m = model.params_from_reference(_reference_arrays(jcfg), cfg,
                                    device="cpu")
    batch = _batch(cfg, 6)
    for p in m.parameters():
        p.requires_grad_(True)
    loss, _ = model.loss_fn(m, batch["tokens"], batch["labels"])
    assert loss.requires_grad and not loss.is_inference()
    assert model.apply_train(m, batch["tokens"]).is_inference()


def test_train_flops_analytic_matches_reference():
    for arch in configs.ARCH_IDS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke_config,
                           jconfigs.get_smoke_config)):
            assert model.train_flops_analytic(get(arch), 4, 4096) == \
                jmodel.train_flops_analytic(jget(arch), 4, 4096), arch


# -- AdamW -------------------------------------------------------------------------

def test_schedule_matches_reference():
    cfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    jcfg = jadamw.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    for step in range(0, 45, 3):
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jadamw.schedule(jcfg, jnp.int32(step))
        np.testing.assert_allclose(float(got), float(want), rtol=SCALAR_RTOL)


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "zamba2-1.2b",
                                  "rwkv6-7b"])
def test_adamw_decays_the_reference_leaves(arch):
    """Weight decay falls on the leaves of two or more dims in the
    reference's stacked layout: every block's norm scale (L, d) yes,
    ``ln_f`` (d,) and the hybrid's unstacked shared block's norms no."""
    cfg, jcfg = _pair(arch)
    m = model.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    want = sorted(jax.tree_util.keystr(path) for path, a in
                  jax.tree_util.tree_leaves_with_path(
                      jmodel.init(jax.random.PRNGKey(0), jcfg))
                  if a.ndim >= 2)
    got = sorted({"".join(f"['{k}']" for k in model.reference_path(n)[0])
                  for n in adamw.decayed(m)})
    assert got == want
    decayed = set(adamw.decayed(m))
    assert "ln_f.scale" not in decayed
    if cfg.block == "mamba":
        assert not any(n.startswith("body.shared_attn.ln")
                       for n in decayed)
    else:
        assert any(n.startswith("body.") and n.endswith(".scale")
                   for n in decayed)


def test_adamw_apply_matches_reference_over_five_steps():
    """Five `apply` steps from the same gradients: parameters, moments,
    step, grad_norm and lr as the reference's (a stacked norm scale decays,
    ``ln_f`` does not; the third step's gradients are clipped)."""
    cfg, jcfg = _pair("smollm-360m")
    arrays = _reference_arrays(jcfg)
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=5.0)
    m = model.params_from_reference(arrays, cfg, device="cpu")
    state = adamw.init(m)
    jp = jax.tree.map(jnp.asarray, arrays)
    jstate = jadamw.init(jp)
    rng = np.random.default_rng(8)
    names = [n for n, _ in m.named_parameters()]
    for step in range(5):
        scale = 40.0 if step == 2 else 0.3
        g = {n: torch.from_numpy((scale * rng.standard_normal(
            p.shape)).astype(np.float32)) for n, p in m.named_parameters()}
        jg = jax.tree.map(jnp.asarray, model.to_reference(g))
        m, state, met = adamw.apply(adamw.AdamWConfig(**opt), m, g, state)
        jp, jstate, jmet = jadamw.apply(jadamw.AdamWConfig(**opt), jp, jg,
                                        jstate)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=SCALAR_RTOL)
    assert int(state.step) == int(jstate.step) == 5
    for got, want in ((model.params_to_reference(m), jp),
                      (model.to_reference(state.mu), jstate.mu),
                      (model.to_reference(state.nu), jstate.nu)):
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, b, err_msg=path, **ADAMW_TOL)
    # ln_f moved by its gradients alone; a block's norm scale also decayed
    assert "ln_f.scale" in names and "ln_f.scale" not in adamw.decayed(m)
    assert "body.blocks.0.ln1.scale" in adamw.decayed(m)


# -- the train step ----------------------------------------------------------------

def _reference_steps(arch, accum, jit=True):
    """The reference's three `make_train_step` steps from the perturbed
    init on batch seeds 10, 11 and 12, jitted or eager: (each step's
    metrics, the parameters, the first moments)."""
    _, jcfg = _pair(arch)
    jstep = jtrain.make_train_step(jcfg, jtrain.TrainOptions(
        grad_accum=accum, adamw=jadamw.AdamWConfig(**STEP_OPT)))
    jp = jax.tree.map(jnp.asarray, _reference_arrays(jcfg))
    jo = jadamw.init(jp)
    mets = []
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.nullcontext() if jit else jax.disable_jit():
        _reference_patch(mp, arch)
        if jit:
            jstep = jax.jit(jstep)
        for i in range(3):
            jp, jo, jm = jstep(jp, jo, _batch(jcfg, 10 + i))
            mets.append({k: float(v) for k, v in jm.items()})
    return mets, _leaves(jp), _leaves(jo.mu)


def _rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a - b)


def _offsets(got, want):
    """|got - want| over every element of two lists of leaves."""
    return np.concatenate([np.abs(a - b).ravel()
                           for (_, a), (_, b) in zip(got, want)])


@pytest.fixture(scope="module")
def reference_spread():
    """How far the reference's eager evaluation of rwkv6's three steps
    (accumulation 1) lies from its jitted one: each metric's largest
    relative difference over the steps, the parameters beyond 1e-6
    ("beyond") and the largest first-moment difference ("mu")."""
    jm, jp, jmu = _reference_steps("rwkv6-7b", 1)
    em, ep, emu = _reference_steps("rwkv6-7b", 1, jit=False)
    spread = {k: max(_rel(e[k], j[k]) for e, j in zip(em, jm))
              for k in jm[0]}
    spread["beyond"] = int((_offsets(ep, jp) > 1e-6).sum())
    spread["mu"] = float(_offsets(emu, jmu).max())
    return spread


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, accum, request):
    """Three `make_train_step` steps against ``jax.jit(make_train_step)``
    from the same weights and batches: every metric, then the parameters
    and moments. rwkv6's reference runs its exact recurrence, and each of
    its bars is the larger of the others' and twice the reference's own
    eager-to-jit spread (the module docstring says why)."""
    cfg, jcfg = _pair(arch)
    jms, jp, jmu = _reference_steps(arch, accum)
    step = train.make_train_step(cfg, train.TrainOptions(
        grad_accum=accum, adamw=adamw.AdamWConfig(**STEP_OPT)))
    m = model.params_from_reference(_reference_arrays(jcfg), cfg,
                                    device="cpu")
    o = adamw.init(m)
    spread = (request.getfixturevalue("reference_spread")
              if arch in EXACT_SCAN_ARCHS else {})
    for i, jm in enumerate(jms):
        m, o, met = step(m, o, _batch(cfg, 10 + i))
        assert set(met) == set(jm) == {"ce", "aux", "loss", "grad_norm",
                                       "lr"}
        for k in jm:
            assert met[k].shape == () and not met[k].requires_grad
            np.testing.assert_allclose(
                float(met[k]), jm[k], atol=1e-9, err_msg=f"step {i} {k}",
                rtol=max(SCALAR_RTOL, 2 * spread.get(k, 0.0)))
    off = _offsets(_leaves(model.params_to_reference(m)), jp)
    assert off.max() <= STEP_LR
    assert (off > 1e-6).sum() <= max(off.size / 5000,
                                     2 * spread.get("beyond", 0))
    mu_bar = max(1e-7, 2 * spread.get("mu", 0.0))
    for (path, a), (_, b) in zip(_leaves(model.to_reference(o.mu)), jmu):
        assert np.abs(a - b).max() <= mu_bar, path


def test_accumulation_splits_rows_as_the_reference():
    """With grad_accum 2 the loss is the mean of the two halves' losses
    and ce the second half's."""
    cfg, jcfg = _pair("smollm-360m")
    arrays = _reference_arrays(jcfg)
    batch = _batch(cfg, 20)
    halves = [model.loss_fn(model.params_from_reference(arrays, cfg,
                                                        device="cpu"),
                            batch["tokens"][i:i + 2],
                            batch["labels"][i:i + 2])[0] for i in (0, 2)]
    m = model.params_from_reference(arrays, cfg, device="cpu")
    _, _, met = train.make_train_step(cfg, train.TrainOptions(grad_accum=2))(
        m, adamw.init(m), batch)
    assert float(met["loss"]) == pytest.approx(float(sum(halves) / 2),
                                               rel=SCALAR_RTOL)
    assert float(met["ce"]) == pytest.approx(float(halves[1]),
                                             rel=SCALAR_RTOL)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_linear_scan_families_train_on_every_device(arch, device):
    """Mamba2 and RWKV6 blocks train through linear_scan's backward on
    both devices, at full width (zamba2's shared block at the backward
    kernel's (64, 64); rwkv6 has no attention) and at smoke width on the
    CPU; `make_train_step` builds."""
    train.check_trainable(configs.get_config(arch), device)
    if device == "cpu":
        train.check_trainable(configs.get_smoke_config(arch), device)
    assert callable(train.make_train_step(configs.get_config(arch)))


@pytest.mark.parametrize("arch,ok", [("smollm-360m", True),
                                     ("musicgen-medium", True),
                                     ("yi-6b", True),
                                     ("deepseek-v2-236b", True),
                                     ("yi-6b-smoke", False)])
def test_card_training_needs_the_backward_kernels_head_dims(arch, ok):
    """On the card attention trains at the backward kernel's pairs: (64,
    64) for smollm and musicgen, (128, 128) for yi-6b, (192, 128) for
    deepseek-v2's MLA; a smoke config's (16, 16) is refused there. On the
    CPU the plain backward takes any."""
    cfg = (configs.get_smoke_config(arch[:-len("-smoke")])
           if arch.endswith("-smoke") else configs.get_config(arch))
    train.check_trainable(cfg, "cpu")
    if ok:
        train.check_trainable(cfg, "cuda")
    else:
        with pytest.raises(NotImplementedError, match="not \\(16, 16\\)"):
            train.check_trainable(cfg, "cuda")


def test_backward_kernel_refuses_other_head_dims():
    """The backward kernel takes the forward's three pairs and no other;
    at Sk != S it raises, naming ROADMAP.md (queued there)."""
    from repro_torch.kernels.flash_attention import ops
    for dims in ((64, 64), (128, 128), (192, 128)):
        ops.check_backward(*dims)
    for dims in ((16, 16), (128, 64), (64, 128), (192, 192)):
        with pytest.raises(ValueError, match="forward kernel's pairs"):
            ops.check_backward(*dims)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ops.check_backward(128, 128, 128, 256)


# -- the plain backward --------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 37, 6, 2, 16, 16), (1, 20, 4, 4, 24,
                                                           16)])
def test_attention_bwd_ref_matches_autograd(shape, causal):
    """The plain backward (the kernel's plain version) against autograd
    through `attention_ref`, and `flash_attention`'s gradient on CPU
    tensors against both (float32, atol = rtol = 2e-5)."""
    from repro_torch.kernels.flash_attention import ops, ref
    b, s, h, kv, dh, dv = shape
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .requires_grad_(True) for sh in ((b, h, s, dh), (b, kv, s, dh),
                                                (b, kv, s, dv)))
    do = torch.from_numpy(rng.standard_normal((b, h, s, dv)).astype(
        np.float32))
    o = ref.attention_ref(q, k, v, causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.attention_bwd_ref(q, k, v, o.detach(), do, causal)
    o2 = ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                             causal=causal)
    via_op = torch.autograd.grad(o2, (q, k, v), do.transpose(1, 2))
    for g, w, op in zip(got, want, via_op):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(op, w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 37, 6, 2, 16, 16), (1, 20, 4, 4, 24,
                                                           16)])
def test_attention_bwd_ref_given_the_lse_matches_it_without(shape, causal):
    """The plain backward with P = exp(scores − lse) from the forward's
    lse against the same backward with its own softmax (float32,
    atol = rtol = 1e-6: the two P differ by float32 rounding)."""
    from repro_torch.kernels.flash_attention import ref
    b, s, h, kv, dh, dv = shape
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, h, s, dh), (b, kv, s, dh), (b, kv, s, dv)))
    do = torch.from_numpy(rng.standard_normal((b, h, s, dv)).astype(
        np.float32))
    o, lse = ref.attention_ref(q, k, v, causal, return_lse=True)
    with_lse = ref.attention_bwd_ref(q, k, v, o, do, causal, lse=lse)
    without = ref.attention_bwd_ref(q, k, v, o, do, causal)
    for a, w in zip(with_lse, without):
        torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("grad", [True, False])
def test_flash_attention_keeps_the_lse_only_for_a_gradient(monkeypatch,
                                                           grad):
    """The autograd Function asks the forward for its lse only where an
    input needs a gradient, and hands that lse to the backward; the
    gradients equal autograd through the plain forward (float32,
    atol = rtol = 2e-5)."""
    from repro_torch.kernels.flash_attention import ops, ref
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .requires_grad_(grad)
               for sh in ((1, 30, 4, 16), (1, 30, 2, 16), (1, 30, 2, 16)))
    asked, given = [], []
    plain_fwd, plain_bwd = ref.attention_ref, ref.attention_bwd_ref

    def fwd(*a, return_lse=False):
        asked.append(return_lse)
        return plain_fwd(*a, return_lse=return_lse)

    def bwd(*a, lse=None):
        given.append(lse)
        return plain_bwd(*a, lse=lse)

    monkeypatch.setattr(ref, "attention_ref", fwd)
    monkeypatch.setattr(ref, "attention_bwd_ref", bwd)
    o = ops.flash_attention(q, k, v)
    assert asked == [grad]
    if not grad:
        assert not o.requires_grad
        return
    do = torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
    got = torch.autograd.grad(o, (q, k, v), do)
    _, lse = plain_fwd(*(t.detach().transpose(1, 2) for t in (q, k, v)),
                       True, return_lse=True)
    assert len(given) == 1 and torch.equal(given[0], lse)
    want = torch.autograd.grad(
        plain_fwd(*(t.transpose(1, 2) for t in (q, k, v)), True),
        (q, k, v), do.transpose(1, 2))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


# -- the backward at the wider head dims -------------------------------------

def _jax_attention_grads(q, k, v, do, causal):
    """dq, dk, dv of the JAX package's attention, by `jax.grad` of
    <o, do>: causal through ``chunked_causal_attention`` (the reference
    model's prefill attention, chunks of 100 queries and 40 keys), not
    causal through its kernel's plain version ``attention_ref`` with v
    padded by zero columns to q's head dim (it takes dv = dh; the padded
    columns of o are zero and take a zero cotangent). numpy (B,S,·,d) in,
    numpy out."""
    from repro.kernels.flash_attention import ref as jref
    from repro.models import attention as jattention
    dv = v.shape[-1]

    def inner(q, k, v):
        if causal:
            return jattention.chunked_causal_attention(
                q, k, v, q_chunk=100, kv_chunk=40)
        pad = jnp.pad(v, ((0, 0), (0, 0), (0, 0),
                          (0, q.shape[-1] - dv)))
        o = jref.attention_ref(*(x.transpose(0, 2, 1, 3) for x in (q, k, pad)),
                               causal=False)
        return o.transpose(0, 2, 1, 3)[..., :dv]

    grads = jax.grad(lambda q, k, v: jnp.sum(inner(q, k, v) * do),
                     argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(128, 128), (192, 128)])
def test_attention_bwd_ref_matches_jax_at_the_wide_head_dims(dims, causal):
    """The plain backward (the backward kernel's plain version) at the two
    wider pairs of the kernel, GQA (H 4, KV 2) at a ragged S of 200, given
    the forward's lse, and `flash_attention`'s gradient on CPU tensors,
    against ``jax.grad`` of the JAX package's attention from the same numpy
    inputs: each of dq, dk, dv within 2e-5 of its largest |value|."""
    from repro_torch.kernels.flash_attention import ops, ref
    b, s, h, kv = 1, 200, 4, 2
    dh, dv = dims
    rng = np.random.default_rng(dh + causal)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, s, h, dh), (b, s, kv, dh), (b, s, kv, dv), (b, s, h, dv)))
    want = _jax_attention_grads(q, k, v, do, causal)
    qt, kt, vt, dot = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    o, lse = ref.attention_ref(qt, kt, vt, causal, return_lse=True)
    plain = [g.transpose(1, 2) for g in
             ref.attention_bwd_ref(qt, kt, vt, o, dot, causal, lse=lse)]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    via_op = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, a, c, w in zip(("dq", "dk", "dv"), plain, via_op, want):
        assert a.shape == w.shape, name
        bar = GRAD_TOL * np.abs(w).max()
        assert np.abs(a.numpy() - w).max() <= bar, name
        assert np.abs(c.numpy() - w).max() <= bar, name


@pytest.mark.parametrize("arch,change", [
    ("yi-6b", dict(head_dim=128)),
    ("deepseek-v2-236b", dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                              v_head_dim=128))])
def test_loss_and_gradient_at_the_wide_head_dims_match_reference(arch,
                                                                 change):
    """A narrow smoke model at the backward kernel's wider pairs, yi-6b's
    GQA at head dim 128 and deepseek-v2's MLA at (128 + 64, 128): the
    loss and every gradient leaf against ``jax.value_and_grad`` (as
    `test_loss_and_every_gradient_leaf_match_reference`, 2e-5 of each
    leaf's largest |value|)."""
    cfg, jcfg = _pair(arch, **change)
    assert train.attention_head_dims(cfg) in ((128, 128), (192, 128))
    arrays = _reference_arrays(jcfg)
    batch = _batch(cfg, 12)
    (jl, (jce, jaux)), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch["tokens"], batch["labels"]),
        has_aux=True)(jax.tree.map(jnp.asarray, arrays))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    loss, ce, aux, grads = _grads(m, batch["tokens"], batch["labels"])
    for got, want in ((loss, jl), (ce, jce), (aux, jaux)):
        np.testing.assert_allclose(float(got), float(want), rtol=SCALAR_RTOL)
    want, got = _leaves(jg), _leaves(model.to_reference(grads))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), path


# -- lm_batches ----------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 3])
def test_lm_batches_match_reference_exactly(start):
    kw = dict(key_seed=11, num_steps=6, global_batch=4, seq_len=9,
              vocab=2048, start_step=start)
    got, want = list(synthetic.lm_batches(**kw)), list(
        jsynthetic.lm_batches(**kw))
    assert len(got) == len(want) == 6 - start
    for a, b in zip(got, want):
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# -- gradient compression ---------------------------------------------------------

def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((5, 7)) * 3).astype(np.float32),
            "b": rng.standard_normal(11).astype(np.float32)}


def test_compress_tree_matches_reference():
    g, r = _grad_tree(1), _grad_tree(2)
    for residuals in (None, r):
        q, res = grad_compress.compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()},
            None if residuals is None else
            {k: torch.from_numpy(v) for k, v in residuals.items()})
        jq, jres = jgc.compress_tree(g, residuals)
        for k in g:
            assert q[k][0].dtype == torch.int8
            np.testing.assert_array_equal(q[k][0].numpy(),
                                          np.asarray(jq[k][0]))
            assert float(q[k][1]) == float(jq[k][1])
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(jres[k]))
            np.testing.assert_array_equal(
                grad_compress.dequantize_int8(*q[k]).numpy(),
                np.asarray(jgc.dequantize_int8(*jq[k])))


def _psum_rank(rank: int, world: int, pod: int, root: str) -> None:
    """One gloo rank of `world` in pods of `pod`: two rounds of
    `hierarchical_psum` (the second fed the first's residuals) and one
    uncompressed."""
    torch.set_num_threads(1)
    root = pathlib.Path(root)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / "store"), world), rank=rank, world_size=world)
    try:
        pods = [list(range(p * pod, (p + 1) * pod))
                for p in range(world // pod)]
        lanes = [list(range(i, world, pod)) for i in range(pod)]
        in_pod = [dist.new_group(r) for r in pods][rank // pod]
        cross = [dist.new_group(r) for r in lanes][rank % pod]
        out = {}
        res = None
        for rnd in range(2):
            g = {k: torch.from_numpy(v)
                 for k, v in _grad_tree(100 * rnd + rank).items()}
            out[f"sum{rnd}"], res = grad_compress.hierarchical_psum(
                g, in_pod_group=in_pod, cross_pod_group=cross, residuals=res)
            out[f"res{rnd}"] = res
        out["plain"], _ = grad_compress.hierarchical_psum(
            {k: torch.from_numpy(v) for k, v in _grad_tree(rank).items()},
            in_pod_group=in_pod, cross_pod_group=cross, compress=False)
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world,pod", [(2, 1), (2, 2), (4, 2)])
def test_hierarchical_psum_on_gloo_ranks_matches_reference(world, pod,
                                                           tmp_path):
    """The in-pod float32 sum, then each pod's sum quantized by the
    reference's `compress_tree` (with its residuals) and summed across
    pods: the same numbers on every rank, and each rank's residuals are
    its pod's."""
    ctx = tmp.start_processes(_psum_rank, args=(world, pod, str(tmp_path)),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not end in time")
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    n_pods = world // pod
    res = [None] * n_pods
    for rnd in range(2):
        trees = [_grad_tree(100 * rnd + r) for r in range(world)]
        pod_sums = [{k: sum(trees[r][k] for r in range(p * pod,
                                                       (p + 1) * pod))
                     for k in trees[0]} for p in range(n_pods)]
        total = {k: 0.0 for k in trees[0]}
        for p in range(n_pods):
            jq, res[p] = jgc.compress_tree(pod_sums[p], res[p])
            for k in total:
                total[k] = total[k] + np.asarray(jgc.dequantize_int8(*jq[k]))
        for r in range(world):
            for k in total:
                np.testing.assert_allclose(outs[r][f"sum{rnd}"][k].numpy(),
                                           total[k], rtol=1e-6, atol=1e-6)
                np.testing.assert_array_equal(
                    outs[r][f"res{rnd}"][k].numpy(),
                    np.asarray(res[r // pod][k]))
    trees = [_grad_tree(r) for r in range(world)]
    for r in range(world):
        for k in trees[0]:
            np.testing.assert_allclose(outs[r]["plain"][k].numpy(),
                                       sum(t[k] for t in trees), rtol=1e-6,
                                       atol=1e-6)
