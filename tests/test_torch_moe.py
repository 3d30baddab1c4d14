"""The port's MoE layer and MoE models against the JAX package, on the CPU.

The models are llama4-maverick's smoke config (interleaved pairs: a dense
block, then an MoE block of 4 experts, top-1 sigmoid, one shared) and
deepseek-v2's smoke config with ``use_mla=False`` (a dense prefix of one
block, then MoE blocks of 8 experts, top-2 softmax, one shared; its MLA
is held in ``tests/test_torch_mla.py``), in float32, with the JAX package's own
``model.init(PRNGKey(0), cfg)`` weights carried across by
`params_from_reference`; norm scales are perturbed with seeded noise so
that they are exercised. Each runs at the capacity factor 1.25 of the
configs and at 0.5, where the capacity drops assignments.

Tolerances, float32 throughout:
* routing: expert ids, dropped assignments and slots exact; gates within
  atol = rtol = 2e-5 (the port rounds a float64 softmax or sigmoid to
  float32, the reference computes it in float32: a few ulps);
* ``moe_apply``'s output and aux loss, one block: atol = rtol = 2e-5. A
  drop or a slot that differs from the reference's moves a token's output
  by a whole expert's, far above it;
* logits after the full model: within 2e-5 of the largest |logit|;
  proxy scores rtol 1e-4 (as ``tests/test_torch_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model, moe, transformer  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
LLAMA4 = "llama4-maverick-400b-a17b"
DSV2 = "deepseek-v2-236b"


def _pair(arch, **change):
    """(port config, reference config) of `arch`'s smoke config with
    `change`; deepseek-v2 without MLA (its GQA attention puts the MoE
    layout alone under test), built from the reference's."""
    jcfg = jconfigs.get_smoke_config(arch)
    if arch == DSV2:
        change = dict(use_mla=False, **change)
    jcfg = dataclasses.replace(jcfg, **change)
    return ModelConfig(**dataclasses.asdict(jcfg)), jcfg


ARCHS = (LLAMA4, DSV2)
FACTORS = (1.25, 0.5)


def _reference_arrays(jcfg, seed=0):
    """The reference's init at PRNGKey(0) as numpy, norm scales perturbed
    from `seed` by 1 + N(0, 0.2²)."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return (a * (1 + 0.2 * rng.standard_normal(a.shape))).astype(
                a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, jmodel.init(jax.random.PRNGKey(0), jcfg))


def _moe_block_name(cfg):
    return "pairs_moe" if cfg.moe_layer_step > 1 else "moe_blocks"


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _hidden(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


# -- routing ------------------------------------------------------------------

def _logits(data, n, e, seed):
    rng = np.random.default_rng(seed)
    if data == "ties":
        # few distinct values a row: most top-k choices break a tie
        return rng.integers(-2, 2, (n, e)).astype(np.float32) / 2
    return rng.standard_normal((n, e)).astype(np.float32) * 2


@pytest.mark.parametrize("data", ["normal", "ties"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("gate_fn", ["softmax", "sigmoid"])
def test_top_k_routing_matches_reference(gate_fn, k, data):
    """Ids exact (among equal gates the lowest index, as jax.lax.top_k);
    gates and every expert's gate within 2e-5."""
    logits = _logits(data, 200, 8, k)
    want = jmoe.top_k_routing(jnp.asarray(logits), k, gate_fn)
    got = moe.top_k_routing(torch.from_numpy(logits), k, gate_fn)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if data == "ties":
        assert (np.diff(np.sort(logits)[:, -k - 1:], axis=1) == 0).any()


def _plain_dispatch(ids, e, cap):
    """Each assignment in token-major order: its expert's count so far
    decides whether it is kept and at which slot."""
    n, k = ids.shape
    seen = [0] * e
    keep, slot = {}, {}
    for t in range(n):
        for j in range(k):
            ex = int(ids[t, j])
            keep[t, j] = seen[ex] < cap
            slot[t, j] = ex * cap + seen[ex] if keep[t, j] else e * cap
            seen[ex] += 1
    return keep, slot


@pytest.mark.parametrize("cap", [8, 3, 40])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_dispatch_keeps_the_first_cap_of_each_expert(k, cap):
    """`dispatch` against a plain walk over the assignments: the first
    `cap` of each expert are kept, in token order, at consecutive slots;
    the rest go to the overflow row E · cap."""
    e = 8
    ids = moe.top_k_routing(torch.from_numpy(_logits("normal", 50, e, k)),
                            k)[0]
    order, tok_sorted, slot, keep = moe.dispatch(ids, e, cap)
    want_keep, want_slot = _plain_dispatch(ids.numpy(), e, cap)
    for i, a in enumerate(order.tolist()):
        t, j = divmod(a, k)
        assert tok_sorted[i] == t
        assert bool(keep[i]) == want_keep[t, j]
        assert int(slot[i]) == want_slot[t, j]
    assert sorted(order.tolist()) == list(range(50 * k))


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    """One MoE layer of the reference's weights on (2, 64) tokens: output
    and aux loss within 2e-5. At capacity factor 0.5 assignments are
    dropped (checked on the port's routing, whose ids equal the
    reference's)."""
    cfg, jcfg = _pair(arch, capacity_factor=cf)
    arrays = _reference_arrays(jcfg)
    name = _moe_block_name(cfg)
    p = jax.tree.map(lambda a: a[0], arrays["body"][name])["moe"]
    x = _hidden(cfg, 2, 64, 3)
    gate_fn = transformer.gate_fn_of(cfg)
    want, want_aux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                                    jnp.asarray(x), gate_fn)
    pm = getattr(model.params_from_reference(arrays, cfg, device="cpu")
                 .body, name)[0].moe
    got, aux = moe.moe_apply(pm, cfg, torch.from_numpy(x), gate_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
    assert aux.shape == () and aux.dtype == torch.float32

    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    ids = moe.top_k_routing(xt @ pm.router, cfg.num_experts_per_tok,
                            gate_fn)[0]
    jids = jmoe.top_k_routing(jnp.asarray(x.reshape(-1, cfg.d_model))
                              @ p["router"], cfg.num_experts_per_tok,
                              gate_fn)[0]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    keep = moe.dispatch(ids, cfg.num_experts, moe.capacity(cfg, 128))[3]
    if cf == 0.5:
        assert int(keep.sum()) < keep.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_matches_reference_structure(arch):
    """The router float32 (d, E), the expert stacks (E, d, ff) and
    (E, ff, d) in cfg.dtype and the shared experts' MLP, under the
    reference's names; the experts drawn one at a time by the reference's
    law (1/sqrt(d_in) times a standard normal cut at ±2)."""
    cfg, jcfg = _pair(arch, dtype="bfloat16")
    want = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0),
                                                  jcfg))
    got = moe.init_moe(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    shapes = {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
              for n, t in got.named_parameters()}
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert shapes == {".".join(k.key for k in path):
                      (a.shape, a.dtype.name) for path, a in flat}
    w = got.w_gate.float() * np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2.0 + 1e-2
    assert not torch.equal(got.w_gate[0], got.w_gate[1])


# -- blocks and the whole model -----------------------------------------------

@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_block_prefill_with_moe_matches_reference(arch, cf):
    cfg, jcfg = _pair(arch, capacity_factor=cf)
    arrays = _reference_arrays(jcfg, seed=1)
    name = _moe_block_name(cfg)
    blk = jax.tree.map(lambda a: a[0], arrays["body"][name])
    x, pos = _hidden(cfg, 2, 48, 6), np.tile(np.arange(48), (2, 1))
    want, want_aux = jtransformer.attn_block_prefill(
        jax.tree.map(jnp.asarray, blk), jcfg, jnp.asarray(x),
        jnp.asarray(pos), "moe", transformer.gate_fn_of(cfg))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    got, aux = transformer.attn_block_prefill(
        getattr(m.body, name)[0], cfg, torch.from_numpy(x),
        torch.from_numpy(pos), "moe")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_body_prefill_returns_x_and_aux_as_reference(arch, cf):
    """The body's hidden states and its aux loss, summed over the MoE
    blocks, within 2e-5 of the largest |output|."""
    cfg, jcfg = _pair(arch, capacity_factor=cf)
    arrays = _reference_arrays(jcfg, seed=2)
    x, pos = _hidden(cfg, 2, 40, 7), np.tile(np.arange(40), (2, 1))
    want, want_aux = jtransformer.body_prefill(
        jax.tree.map(jnp.asarray, arrays["body"]), jcfg, jnp.asarray(x),
        jnp.asarray(pos))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    got, aux = transformer.body_prefill(m.body, cfg, torch.from_numpy(x),
                                        torch.from_numpy(pos))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s", [(2, 40), (1, 33)])
def test_apply_train_logits_match_reference(arch, cf, b, s):
    cfg, jcfg = _pair(arch, capacity_factor=cf)
    arrays = _reference_arrays(jcfg)
    tokens = _tokens(cfg, b, s, b * s)
    want, _ = jmodel.apply_train(jax.tree.map(jnp.asarray, arrays), jcfg,
                                 jnp.asarray(tokens))
    want = np.asarray(want)
    got = model.apply_train(
        model.params_from_reference(arrays, cfg, device="cpu"), tokens)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_proxy_scores_match_reference(arch):
    cfg, jcfg = _pair(arch)
    arrays = _reference_arrays(jcfg)
    tokens = _tokens(cfg, 4, 20, 1)
    want = jserve.make_serve_prefill(jcfg)(jax.tree.map(jnp.asarray, arrays),
                                           {"tokens": jnp.asarray(tokens)})
    m = model.params_from_reference(arrays, cfg, device="cpu")
    got = serve.make_serve_prefill(cfg)(m, {"tokens": tokens})
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_structure(arch):
    """`init` and the carried reference weights: the same parameter names,
    shapes and dtypes, block by block (``pairs_dense``/``pairs_moe`` or
    ``dense_prefix``/``moe_blocks``)."""
    cfg, jcfg = _pair(arch)
    m = model.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    carried = model.params_from_reference(_reference_arrays(jcfg), cfg,
                                          device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in carried.named_parameters()}
    assert sorted(dict(m.body.named_children())) == sorted(
        name for name, *_ in transformer.moe_layout(cfg))


def test_params_from_reference_keeps_expert_stacks():
    """Block i holds slice i; an expert stack stays (E, d, ff), in bf16."""
    cfg, jcfg = _pair(LLAMA4, dtype="bfloat16", num_layers=4)
    arrays = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  jcfg))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    w = m.body.pairs_moe[1].moe.w_gate
    assert w.dtype == torch.bfloat16
    assert tuple(w.shape) == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    np.testing.assert_array_equal(
        w.float().numpy(),
        arrays["body"]["pairs_moe"]["moe"]["w_gate"][1].astype(np.float32))
    assert m.body.pairs_moe[1].moe.router.dtype == torch.float32


def test_first_k_dense_zero_builds_and_runs_one_more_block():
    """The reference's quirk, mirrored: with first_k_dense = 0 a dense-
    prefix body builds max(0, 1) = 1 dense block before its L MoE blocks
    and runs all L + 1, while the count takes first_k_dense (0) dense
    blocks and L MoE blocks."""
    cfg, jcfg = _pair(DSV2, first_k_dense=0)
    arrays = _reference_arrays(jcfg)
    assert arrays["body"]["dense_prefix"]["ln1"]["scale"].shape[0] == 1
    assert arrays["body"]["moe_blocks"]["ln1"]["scale"].shape[0] == \
        cfg.num_layers
    m = model.params_from_reference(arrays, cfg, device="cpu")
    assert len(m.body.dense_prefix) == 1
    assert len(m.body.moe_blocks) == cfg.num_layers
    fresh = model.init(cfg, generator=torch.Generator(), device="cpu")
    assert len(fresh.body.dense_prefix) + len(fresh.body.moe_blocks) \
        == cfg.num_layers + 1
    caches = model.init_caches(cfg, 1, 4, torch.float32, device="cpu")
    assert [len(caches[k]) for k in ("dense_prefix", "moe_blocks")] == \
        [1, cfg.num_layers]
    d, expert = cfg.d_model, 3 * cfg.d_model * cfg.moe_d_ff
    attn = 2 * d * cfg.num_heads * cfg.head_dim \
        + 2 * d * cfg.num_kv_heads * cfg.head_dim
    per_moe = expert * (cfg.num_experts + cfg.num_shared_experts) \
        + d * cfg.num_experts
    assert model.count_params_analytic(cfg) == \
        jmodel.count_params_analytic(jcfg) == \
        2 * cfg.vocab_size * d + cfg.num_layers * (attn + per_moe)
    tokens = _tokens(cfg, 2, 24, 5)
    want = np.asarray(jmodel.apply_train(jax.tree.map(jnp.asarray, arrays),
                                         jcfg, jnp.asarray(tokens))[0])
    np.testing.assert_allclose(model.apply_train(m, tokens).numpy(), want,
                               rtol=0, atol=2e-5 * np.abs(want).max())


# -- counts -------------------------------------------------------------------

_NEW = ("yi-6b", "deepseek-7b", "qwen1.5-4b", "chameleon-34b", LLAMA4)
_COUNTED = {**{f"{a}": (configs.get_config(a), jconfigs.get_config(a))
               for a in _NEW},
            **{f"{a}-smoke": (configs.get_smoke_config(a),
                              jconfigs.get_smoke_config(a)) for a in _NEW},
            "deepseek-v2-smoke-without-mla": _pair(DSV2)}


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("case", list(_COUNTED))
def test_count_params_analytic_matches_reference(case, active):
    """Both modes equal the reference's formula; the configs' own
    param_count and active_param_count too."""
    cfg, jcfg = _COUNTED[case]
    want = jmodel.count_params_analytic(jcfg, active_only=active)
    assert model.count_params_analytic(cfg, active_only=active) == want
    got = cfg.active_param_count() if active else cfg.param_count()
    assert got == want == (jcfg.active_param_count() if active
                           else jcfg.param_count())


def test_llama4_counts():
    cfg = configs.get_config(LLAMA4)
    assert cfg.param_count() == 397_691_453_440
    assert cfg.active_param_count() == 14_164_295_680
