"""The port's proxy-scorer model plane against the JAX package, on the CPU.

The same numpy inputs (and, for the model functions, the JAX package's own
``model.init(PRNGKey(0), cfg)`` weights, carried across by
`params_from_reference`) go through both packages in float32. Biases and
norm scales are perturbed with seeded noise first, so that they are
exercised: the reference initialises them to 0 and 1.

Tolerances, float32 throughout:
* layers and one attention or transformer block: atol = rtol = 2e-5;
* logits after the full model: |port - ref| <= 2e-5 · max|ref| (rounding
  errors of a few float32 ulps of the largest logit; the logits reach ~55
  in the smoke model, where their ulp is 3.8e-6);
* proxy scores: rtol 1e-4 (a score is exp of a logit difference, so an
  absolute logit error e moves it by a factor of about 1 + e).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, layers, model, transformer  # noqa: E402

SMOKE = configs.get_smoke_config("smollm-360m")
JSMOKE = jconfigs.get_smoke_config("smollm-360m")
# (port config, reference config) pairs: smollm's smoke config, and the
# same with qkv bias, with qk-norm, and with an untied head and gelu
# (fields of the config the smollm family leaves off)
_VARIANTS = {
    "smollm-smoke": {},
    "qkv_bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True, num_layers=3),
    "untied_gelu": dict(tie_embeddings=False, act="gelu"),
}
CASES = {name: (dataclasses.replace(SMOKE, **kw),
                dataclasses.replace(JSMOKE, **kw))
         for name, kw in _VARIANTS.items()}
# the other dense configs' own smoke configs: GQA (yi), MHA (deepseek-7b),
# QKV bias (qwen1.5) and qk-norm with GQA (chameleon, one token stream)
DENSE = ("yi-6b", "deepseek-7b", "qwen1.5-4b", "chameleon-34b")
CASES.update({arch: (configs.get_smoke_config(arch),
                     jconfigs.get_smoke_config(arch)) for arch in DENSE})
TOL = dict(atol=2e-5, rtol=2e-5)


def _reference_arrays(jcfg, seed=0):
    """The reference's init at PRNGKey(0) as numpy, with every bias and
    norm scale perturbed from `seed`."""
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


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _hidden(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _block0(arrays):
    return jax.tree.map(lambda a: a[0], arrays["body"]["blocks"])


def _positions(b, s):
    return np.tile(np.arange(s), (b, 1))


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 60), (2, 5, 8, 64)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jlayers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = layers.rms_norm(layers.params(scale=torch.from_numpy(scale)),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("head_dim,theta,decode", [
    (64, 10_000.0, False), (20, 500_000.0, False), (128, 10_000.0, False),
    (64, 10_000.0, True)])
def test_apply_rope_matches_reference(head_dim, theta, decode):
    """Prefill positions (B,S) = arange(S) a row, and decode's (B,1): one
    position a row, each its own, out to 32767 (`gqa_decode` passes
    ``pos[:, None]``)."""
    rng = np.random.default_rng(head_dim)
    if decode:
        x = rng.standard_normal((5, 1, 3, head_dim)).astype(np.float32)
        pos = np.array([[0], [1], [4095], [20000], [32767]])
    else:
        x = rng.standard_normal((2, 37, 3, head_dim)).astype(np.float32)
        pos = _positions(2, 37)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(layers.rope_frequencies(head_dim, theta),
                                  jlayers.rope_frequencies(head_dim, theta))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(3)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_gate", (60, 128)), ("w_up", (60, 128)),
                      ("w_down", (128, 60)))}
    x = rng.standard_normal((2, 9, 60)).astype(np.float32)
    want = jlayers.mlp({n: jnp.asarray(a) for n, a in w.items()},
                       jnp.asarray(x), act)
    got = layers.mlp(layers.params(**{n: torch.from_numpy(a)
                                      for n, a in w.items()}),
                     torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_laws():
    """Truncated normals in [-2, 2]·scale with the reference's law (std of
    a standard normal cut at ±2: 0.8796)."""
    g = torch.Generator().manual_seed(0)
    w = layers.dense_init(g, 400, 500, torch.float32, "cpu")
    x = w * np.sqrt(400)
    assert float(x.abs().max()) <= 2.0 + 1e-6
    assert abs(float(x.std()) - 0.8796) < 0.01
    assert abs(float(x.mean())) < 0.01


# -- attention and blocks --------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_gqa_prefill_matches_reference(case):
    cfg, jcfg = CASES[case]
    arrays = _reference_arrays(jcfg)
    p = _block0(arrays)["attn"]
    x, pos = _hidden(cfg, 2, 24, 5), _positions(2, 24)
    want = jattention.gqa_prefill(jax.tree.map(jnp.asarray, p), jcfg,
                                  jnp.asarray(x), jnp.asarray(pos))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    got = attention.gqa_prefill(m.body.blocks[0].attn, cfg,
                                torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_attn_block_prefill_matches_reference(case):
    cfg, jcfg = CASES[case]
    arrays = _reference_arrays(jcfg, seed=1)
    x, pos = _hidden(cfg, 3, 16, 6), _positions(3, 16)
    want, _ = jtransformer.attn_block_prefill(
        jax.tree.map(jnp.asarray, _block0(arrays)), jcfg, jnp.asarray(x),
        jnp.asarray(pos))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    got, aux = transformer.attn_block_prefill(m.body.blocks[0], cfg,
                                              torch.from_numpy(x),
                                              torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


# -- the whole model -----------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("b,s", [(2, 16), (1, 33)])
def test_apply_train_logits_match_reference(case, b, s):
    cfg, jcfg = CASES[case]
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


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("target", [1, 7])
def test_proxy_scores_match_reference(case, target):
    cfg, jcfg = CASES[case]
    arrays = _reference_arrays(jcfg)
    tokens = _tokens(cfg, 4, 20, target)
    want = np.asarray(jmodel.proxy_scores(jax.tree.map(jnp.asarray, arrays),
                                          jcfg, jnp.asarray(tokens),
                                          target))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    got = model.proxy_scores(m, tokens, target)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)
    served = serve.make_serve_prefill(cfg, target)(m, {"tokens": tokens})
    jserved = jserve.make_serve_prefill(jcfg, target)(
        jax.tree.map(jnp.asarray, arrays), {"tokens": jnp.asarray(tokens)})
    np.testing.assert_array_equal(served.numpy(), got.numpy())
    np.testing.assert_allclose(served.numpy(), np.asarray(jserved),
                               rtol=1e-4, atol=0)


def test_last_logits_are_the_last_position_of_apply_train():
    cfg, jcfg = CASES["smollm-smoke"]
    m = model.params_from_reference(_reference_arrays(jcfg), cfg,
                                    device="cpu")
    tokens = _tokens(cfg, 3, 12, 0)
    np.testing.assert_allclose(model.last_logits(m, tokens).numpy(),
                               model.apply_train(m, tokens)[:, -1].numpy(),
                               rtol=0, atol=1e-5)


def test_serve_prefill_refuses_a_model_of_another_config():
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    other = dataclasses.replace(SMOKE, name="other")
    with pytest.raises(ValueError, match="model built for"):
        serve.make_serve_prefill(other)(m, {"tokens": np.zeros((1, 4))})


def test_init_matches_reference_structure():
    """`init` and the carried reference weights have the same parameter
    names, shapes and dtypes, block by block."""
    arrays = _reference_arrays(JSMOKE)
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    carried = model.params_from_reference(arrays, SMOKE, device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in carried.named_parameters()}
    assert not any(p.requires_grad for p in m.parameters())
    assert m.cfg is SMOKE


def test_params_from_reference_keeps_bf16():
    jcfg = dataclasses.replace(JSMOKE, dtype="bfloat16")
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    arrays = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  jcfg))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    wq = m.body.blocks[1].attn.wq
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        arrays["body"]["blocks"]["attn"]["wq"][1].astype(np.float32))
    assert m.ln_f.scale.dtype == torch.float32


def test_init_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(SMOKE, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.params_from_reference(_reference_arrays(JSMOKE), SMOKE)


@pytest.mark.parametrize("change", [dict(block="mamba", shared_attn_every=0),
                                    dict(block="xlstm"),
                                    dict(moe=True, moe_layer_step=2,
                                         block="hyena"),
                                    dict(num_codebooks=4, block="xlstm")])
def test_unported_families_raise(change):
    """Unknown block kinds and Mamba2 bodies without the shared block
    raise, on any body (MLA is ported: tests/test_torch_mla.py; multi-
    codebook heads: tests/test_torch_musicgen.py)."""
    cfg = dataclasses.replace(SMOKE, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.count_params_analytic(cfg)


# -- configs --------------------------------------------------------------------

_COUNTED = {"smollm-360m": (configs.get_config("smollm-360m"),
                            jconfigs.get_config("smollm-360m")), **CASES,
            **{f"{arch}-published": (configs.get_config(arch),
                                     jconfigs.get_config(arch))
               for arch in DENSE}}


@pytest.mark.parametrize("case", list(_COUNTED))
def test_count_params_analytic_matches_reference(case):
    """The dense count equals the reference's formula, on smollm-360m and
    on the variants the parity tests run."""
    cfg, jcfg = _COUNTED[case]
    assert model.count_params_analytic(cfg) \
        == jmodel.count_params_analytic(jcfg)


def test_registry_holds_the_ported_arch():
    assert configs.ARCH_IDS == ("smollm-360m", "zamba2-1.2b", "rwkv6-7b",
                                *DENSE, "llama4-maverick-400b-a17b",
                                "deepseek-v2-236b", "musicgen-medium")
    for arch in configs.ARCH_IDS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke_config,
                           jconfigs.get_smoke_config)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                jget(arch))
    cfg = configs.get_config("smollm-360m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfigs.get_config("smollm-360m"))
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(JSMOKE)
    assert cfg.param_count() == jconfigs.get_config(
        "smollm-360m").param_count() == 361_758_720
    assert [s.name for s in configs.SHAPES] == \
        [s.name for s in jconfigs.SHAPES]
    for shape in configs.SHAPES:
        assert configs.shape_applicable(cfg, shape)[0] == \
            jconfigs.shape_applicable(jconfigs.get_config("smollm-360m"),
                                      jconfigs.SHAPES_BY_NAME[shape.name])[0]


@pytest.mark.parametrize("get", [configs.get_config,
                                 configs.get_smoke_config])
def test_registry_names_the_known_archs(get):
    with pytest.raises(KeyError,
                       match="musicgen-medium.*rwkv6-7b.*smollm-360m.*yi-6b"
                             ".*zamba2-1.2b"):
        get("musicgen-large")


# -- token corpora ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(num_records=2000, seq_len=64,
                                             vocab=49152,
                                             positive_rate=0.02, seed=3)])
def test_make_token_corpus_matches_reference(kw):
    tokens, labels = synthetic.make_token_corpus(**kw)
    jtokens, jlabels = jsynthetic.make_token_corpus(**kw)
    assert tokens.dtype == np.int32 and labels.dtype == np.float32
    np.testing.assert_array_equal(tokens, jtokens)
    np.testing.assert_array_equal(labels, jlabels)
    assert synthetic.MARKER == jsynthetic.MARKER


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.integers(3, 40))
def test_contains_marker_matches_reference(seed, seq_len):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 50, (64, seq_len)).astype(np.int32)
    rows = rng.integers(0, 64, 8)
    offs = rng.integers(0, seq_len - 2, 8)
    for r, o in zip(rows, offs):
        t[r, o:o + 3] = synthetic.MARKER
    np.testing.assert_array_equal(synthetic.contains_marker(t),
                                  jsynthetic.contains_marker(t))
