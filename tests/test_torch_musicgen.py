"""The multi-codebook head (musicgen-medium) against the JAX package, on the
CPU: the config, init's structure, the summed embeddings, logits, proxy
scores, decode (against the reference's and against the port's own
prefill), the caches and the analytic parameter count.

The model is musicgen's smoke config (2 layers, d 64, 4 codebooks of 128)
with the reference's own ``model.init(PRNGKey(0), cfg)`` weights, norm
scales perturbed with seeded noise, carried across by
`params_from_reference`. Tolerances, as tests/test_torch_models.py and
tests/test_torch_decode.py hold the one-codebook models: float32 logits
and decode steps within 2e-5 of the largest |reference logit|, proxy
scores rtol 1e-4; the bf16 embedding sum is exact.
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
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model  # noqa: E402

ARCH = "musicgen-medium"
SMOKE = configs.get_smoke_config(ARCH)
JSMOKE = jconfigs.get_smoke_config(ARCH)
K = SMOKE.num_codebooks
TOL = 2e-5


def _reference_arrays(jcfg=JSMOKE, seed=0):
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return (a * (1 + 0.2 * rng.standard_normal(a.shape))).astype(
                a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, jmodel.init(jax.random.PRNGKey(0), jcfg))


def _tokens(b, s, seed, cfg=SMOKE):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s, cfg.num_codebooks), dtype=np.int32)


def _close(got, want, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_musicgen_is_registered_as_the_reference_config():
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(configs, get)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, get)(ARCH))
    cfg = configs.get_config(ARCH)
    assert (cfg.num_codebooks, cfg.d_model, cfg.num_heads, cfg.head_dim,
            cfg.remat) == (4, 1536, 24, 64, "block")


def test_init_matches_reference_structure():
    """`init` and the carried reference weights: the same names, shapes and
    dtypes, embeddings (K, V, d) and heads (K, d, V)."""
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    carried = model.params_from_reference(_reference_arrays(), SMOKE,
                                          device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in carried.named_parameters()}
    assert shapes["embed.table"][0] == (K, SMOKE.vocab_size, SMOKE.d_model)
    assert shapes["head.w"][0] == (K, SMOKE.d_model, SMOKE.vocab_size)
    assert model.count_params_analytic(SMOKE) == jmodel.count_params_analytic(
        JSMOKE)


def test_init_draws_each_codebook_apart():
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    for t in (m.embed.table, m.head.w):
        assert not torch.equal(t[0], t[1])
        assert float(t.abs().max()) <= 2.0 * max(
            1.0, 1 / np.sqrt(SMOKE.d_model)) + 1e-6


@pytest.mark.parametrize("cfg_case", ["smoke", "published"])
def test_count_params_analytic_matches_reference(cfg_case):
    get, jget = {"smoke": (configs.get_smoke_config,
                           jconfigs.get_smoke_config),
                 "published": (configs.get_config, jconfigs.get_config)}[
        cfg_case]
    got = model.count_params_analytic(get(ARCH))
    assert got == jmodel.count_params_analytic(jget(ARCH))
    if cfg_case == "published":
        assert got == 1_837_105_152     # the gated MLP: 3 · d · d_ff


def test_bf16_embedding_sum_matches_reference_bits():
    """The K bf16 embeddings add one codebook after another, as the
    reference's bf16 ``reduce_sum`` adds them on the CPU."""
    jcfg = dataclasses.replace(JSMOKE, dtype="bfloat16")
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    arrays = jmodel.init(jax.random.PRNGKey(3), jcfg)
    m = model.params_from_reference(jax.tree.map(np.asarray, arrays), cfg,
                                    device="cpu")
    tokens = _tokens(3, 11, 4)
    want = np.asarray(jmodel._embed(arrays, jcfg, jnp.asarray(tokens)).astype(
        jnp.float32))
    got = model._embed(m, torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_reference(dtype):
    """(B, S, K, V) float32 logits of `apply_train` (the heads from float32
    operands); bf16 within 2^-7 of the largest |logit| (a bf16 ulp of the
    hidden states feeding float32 heads)."""
    jcfg = dataclasses.replace(JSMOKE, dtype=dtype)
    cfg = dataclasses.replace(SMOKE, dtype=dtype)
    arrays = _reference_arrays(jcfg)
    tokens = _tokens(2, 13, 1)
    want = np.asarray(jmodel.apply_train(
        jax.tree.map(jnp.asarray, arrays), jcfg, jnp.asarray(tokens))[0])
    got = model.apply_train(model.params_from_reference(arrays, cfg,
                                                        device="cpu"),
                            tokens)
    assert got.shape == (2, 13, K, cfg.vocab_size)
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    tol = TOL * scale if dtype == "float32" else 2 ** -7 * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_proxy_scores_and_last_logits_match_reference():
    """Scores average the last position's K heads' logits before the
    softmax; `last_logits` is (B, K, V)."""
    arrays = _reference_arrays()
    m = model.params_from_reference(arrays, SMOKE, device="cpu")
    tokens = _tokens(5, 9, 2)
    jp = jax.tree.map(jnp.asarray, arrays)
    want = np.asarray(jmodel.proxy_scores(jp, JSMOKE, jnp.asarray(tokens),
                                          target_token=3))
    got = serve.make_serve_prefill(SMOKE, target_token=3)(
        m, {"tokens": tokens})
    assert got.shape == (5,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    full = np.asarray(jmodel.apply_train(jp, JSMOKE, jnp.asarray(tokens))[0])
    last = model.last_logits(m, tokens)
    assert last.shape == (5, K, SMOKE.vocab_size)
    _close(last.numpy(), full[:, -1])


def test_decode_matches_reference():
    """Eight steps of (B, 1, K) tokens through `make_serve_decode` from
    zeroed caches, rows at their own positions: every step's (B, 1, K, V)
    logits and the final caches against the reference's."""
    arrays = _reference_arrays(seed=3)
    jp = jax.tree.map(jnp.asarray, arrays)
    m = model.params_from_reference(arrays, SMOKE, device="cpu")
    b, s = 3, 12
    tokens = _tokens(b, 8, 11)
    jc = jmodel.init_caches(JSMOKE, b, s, jnp.float32)
    pc = model.init_caches(SMOKE, b, s, torch.float32, device="cpu")
    jstep = jserve.make_serve_decode(JSMOKE)
    step = serve.make_serve_decode(SMOKE)
    for t in range(8):
        batch = {"tokens": tokens[:, t:t + 1], "pos": np.array(
            [t, t + 3, t // 2], np.int32)}
        want, jc = jstep(jp, jax.tree.map(jnp.asarray, batch), jc)
        got, pc = step(m, batch, pc)
        assert got.shape == (b, 1, K, SMOKE.vocab_size)
        _close(got.numpy(), np.asarray(want))
    carried = model.caches_from_reference(jax.tree.map(np.asarray, jc),
                                          SMOKE, device="cpu")
    for g, w in zip(jax.tree.leaves(pc), jax.tree.leaves(carried)):
        _close(g.numpy(), w.numpy(), max(float(w.abs().max()), 1e-30))


def test_decode_reproduces_the_prefill():
    """Each step's logits from `init_caches` equal `apply_train`'s at that
    position."""
    m = model.params_from_reference(_reference_arrays(seed=5), SMOKE,
                                    device="cpu")
    tokens = _tokens(2, 10, 6)
    prefill = model.apply_train(m, tokens).numpy()
    caches = model.init_caches(SMOKE, 2, 16, torch.float32, device="cpu")
    for t in range(10):
        lo, caches = model.apply_decode(m, tokens[:, t:t + 1], caches,
                                        [t, t])
        _close(lo[:, 0].numpy(), prefill[:, t])


def test_init_caches_match_reference():
    want = jmodel.init_caches(JSMOKE, 2, 8, jnp.bfloat16)
    got = model.init_caches(SMOKE, 2, 8, device="cpu")
    carried = model.caches_from_reference(jax.tree.map(np.asarray, want),
                                          SMOKE, device="cpu")
    assert jax.tree.structure(got) == jax.tree.structure(carried)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(carried)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_params_to_reference_inverts_params_from_reference():
    arrays = _reference_arrays()
    back = model.params_to_reference(model.params_from_reference(
        arrays, SMOKE, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, arrays))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(a, np.asarray(b))
