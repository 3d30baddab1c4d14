"""The port's Zamba2 (hybrid Mamba2) model against the JAX package, on the
CPU.

The model is zamba2's smoke config in float32, with the JAX package's own
``model.init(PRNGKey(0), cfg)`` weights carried across by
`params_from_reference` (norm scales, D and the conv bias perturbed with
seeded noise so that they are exercised). ``_causal_conv`` agrees within
atol = rtol = 2e-5 (the same float32 operations). Downstream of a scan the
port is held against the reference with its Mamba2 blocks on its exact
recurrence, within 2e-5 of the largest output (the dense model's bar),
at the init's decays and at perturbed ones. At the init's decays it is
also held against the reference's own chunked scan: no farther from it
than the reference's exact recurrence is, plus 2e-5. The chunked scan
forms decay ratios exp(±cumulative log decay) inside 64-step chunks: it
drifts where a chunk's log decay sums far below 0 (0.1 in a body output
of 9.3 at init decays, (3, 128) tokens) and is not finite below about
-88 (``test_port_is_exact_where_the_reference_chunked_scan_fails``); the
port runs the recurrence step by step and has no such range.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import scan_ops as jscan_ops  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.linear_scan import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba, model, transformer  # noqa: E402

ARCH = "zamba2-1.2b"
SMOKE = configs.get_smoke_config(ARCH)
JSMOKE = jconfigs.get_smoke_config(ARCH)


# -- zamba2 --------------------------------------------------------------------------

def _reference_arrays(jcfg, seed=0, decay=False):
    """The reference's init at PRNGKey(0) as numpy, with its norm scales,
    D and conv bias perturbed from `seed`, and with `decay` its dt_bias
    and A_log too (faster and slower decays than the init's A = -1)."""
    rng = np.random.default_rng(seed)
    shift = ("conv_b", "dt_bias", "a_log") if decay else ("conv_b",)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name in ("scale", "d_skip"):
            return (a * (1 + 0.2 * rng.standard_normal(a.shape))).astype(
                a.dtype)
        if name in shift:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, jmodel.init(jax.random.PRNGKey(0), jcfg))


def _exact_scan(q, k, v, w, u=None, initial_state=None, chunk=64):
    return jscan_ops.linear_scan_recurrent(q, k, v, w, u, initial_state)


@pytest.fixture(params=["init_decays", "perturbed_decays"])
def decays(request):
    """The Mamba2 decay parameters the model tests run on: the reference's
    init (A = -1, dt_bias 0), inside the range of its chunked scan, or
    dt_bias and A_log perturbed, where only its exact recurrence is held
    (the chunked scan may not be finite there)."""
    return request.param


def _references(fn, decays):
    """(exact, chunked): `fn()` with the reference's Mamba2 blocks on its
    exact recurrence ``linear_scan_recurrent`` (patched in for
    ``linear_scan_chunked``, in this call only), and on its own chunked
    scan at the init's decays (None at perturbed ones)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jscan_ops, "linear_scan_chunked", _exact_scan)
        exact = np.asarray(fn())
    return exact, (np.asarray(fn()) if decays == "init_decays" else None)


def _close(got, refs, tol=2e-5):
    """Within `tol` of the largest |output| of the reference's exact
    recurrence, and no farther from its chunked scan than that recurrence
    is, plus the same `tol`."""
    exact, chunked = refs
    got = got.numpy()
    atol = tol * np.abs(exact).max()
    assert got.shape == exact.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, exact, rtol=0, atol=atol)
    if chunked is not None:
        assert np.all(np.abs(got - chunked) <= np.abs(exact - chunked) + atol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _mamba0(arrays):
    return jax.tree.map(lambda a: a[0, 0], arrays["body"]["mamba_super"])


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 19, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    want, _ = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b))
    got, _ = mamba._causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("s", [1, 16, 64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_mamba_block_matches_reference(decays, s, seed):
    """One Mamba2 block from a zero state; at S = 1 the reference takes
    its ``scan_ops.step`` branch."""
    arrays = _reference_arrays(JSMOKE, seed, decays == "perturbed_decays")
    x = np.random.default_rng(s + seed).standard_normal(
        (2, s, SMOKE.d_model)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, _mamba0(arrays))
    state = jmamba.init_mamba_state(JSMOKE, 2)
    refs = _references(
        lambda: jmamba.mamba_block(p, JSMOKE, jnp.asarray(x), state)[0],
        decays)
    m = model.params_from_reference(arrays, SMOKE, device="cpu")
    _close(mamba.mamba_block(m.body.mamba_super[0][0], SMOKE,
                             torch.from_numpy(x))[0], refs)


def test_port_is_exact_where_the_reference_chunked_scan_fails():
    """A = -e^1.5 (a strong decay): a 64-step chunk's log decay sums far
    below -88, so the reference's ``linear_scan_chunked`` overflows
    exp(-clog) and its block output is not finite; the port's stays finite
    and equals the reference block on its exact recurrence."""
    arrays = _reference_arrays(JSMOKE)
    arrays["body"]["mamba_super"]["a_log"] = np.full_like(
        arrays["body"]["mamba_super"]["a_log"], 1.5)
    x = np.random.default_rng(3).standard_normal(
        (2, 128, SMOKE.d_model)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, _mamba0(arrays))
    state = jmamba.init_mamba_state(JSMOKE, 2)
    chunked, _ = jmamba.mamba_block(p, JSMOKE, jnp.asarray(x), state)
    assert not np.isfinite(np.asarray(chunked)).all()
    exact, _ = _references(
        lambda: jmamba.mamba_block(p, JSMOKE, jnp.asarray(x), state)[0],
        "perturbed_decays")
    m = model.params_from_reference(arrays, SMOKE, device="cpu")
    _close(mamba.mamba_block(m.body.mamba_super[0][0], SMOKE,
                             torch.from_numpy(x))[0], (exact, None))


@pytest.mark.parametrize("b,s", [(2, 16), (1, 64), (3, 128)])
def test_body_prefill_matches_reference(decays, b, s):
    arrays = _reference_arrays(JSMOKE, decay=decays == "perturbed_decays")
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, SMOKE.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s), (b, 1))
    body = jax.tree.map(jnp.asarray, arrays["body"])
    refs = _references(lambda: jtransformer.body_prefill(
        body, JSMOKE, jnp.asarray(x), jnp.asarray(pos))[0], decays)
    m = model.params_from_reference(arrays, SMOKE, device="cpu")
    _close(transformer.body_prefill(m.body, SMOKE, torch.from_numpy(x),
                                    torch.from_numpy(pos))[0], refs)


@pytest.mark.parametrize("b,s", [(2, 16), (1, 64), (2, 128), (3, 1)])
def test_apply_train_logits_match_reference(decays, b, s):
    """Logits over the whole sequence; S = 1 is a one-token record (the
    reference's ``scan_ops.step`` branch)."""
    arrays = _reference_arrays(JSMOKE, 1, decays == "perturbed_decays")
    tokens = _tokens(SMOKE, b, s, b + s)
    params = jax.tree.map(jnp.asarray, arrays)
    refs = _references(lambda: jmodel.apply_train(
        params, JSMOKE, jnp.asarray(tokens))[0], decays)
    got = model.apply_train(
        model.params_from_reference(arrays, SMOKE, device="cpu"), tokens)
    assert got.dtype == torch.float32
    _close(got, refs)


@pytest.mark.parametrize("target,s", [(1, 32), (7, 64), (3, 1)])
def test_proxy_scores_match_reference(decays, target, s):
    """Scores within rtol 1e-4 (a score is exp of a logit difference, so
    an absolute logit error e moves it by a factor of about 1 + e), the
    bar of the dense model's tests."""
    arrays = _reference_arrays(JSMOKE, target, decays == "perturbed_decays")
    tokens = _tokens(SMOKE, 4, s, target)
    params = jax.tree.map(jnp.asarray, arrays)
    exact, chunked = _references(lambda: jserve.make_serve_prefill(
        JSMOKE, target)(params, {"tokens": jnp.asarray(tokens)}), decays)
    m = model.params_from_reference(arrays, SMOKE, device="cpu")
    got = model.proxy_scores(m, tokens, target)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-4, atol=0)
    if chunked is not None:
        assert np.all(np.abs(got.numpy() - chunked)
                      <= np.abs(exact - chunked) + 1e-4 * exact)
    served = serve.make_serve_prefill(SMOKE, target)(m, {"tokens": tokens})
    np.testing.assert_array_equal(served.numpy(), got.numpy())


def test_scores_lie_inside_the_unit_interval():
    """The untied head at 1/sqrt(d) keeps a random-init model's logits
    near 1, so its scores are spread inside (0, 1), not 0 or 1."""
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    scores = model.proxy_scores(m, _tokens(SMOKE, 16, 32, 0))
    assert bool(((scores > 1e-4) & (scores < 0.5)).all())


def test_init_matches_reference_structure():
    """`init` and the carried reference weights have the same parameter
    names, shapes and dtypes: two super-blocks of two Mamba2 blocks, one
    tail block and one shared attention block."""
    arrays = _reference_arrays(JSMOKE)
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    carried = model.params_from_reference(arrays, SMOKE, device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in carried.named_parameters()}
    assert [len(s) for s in m.body.mamba_super] == [2, 2]
    assert len(m.body.mamba_tail) == 1 and hasattr(m, "head")
    assert transformer.zamba_layout(SMOKE) == (2, 2, 1)
    assert transformer.zamba_layout(configs.get_config(ARCH)) == (6, 6, 2)


def test_mamba_body_without_the_shared_block_raises():
    """shared_attn_every = 0 (a Mamba2 body with no shared block; no config
    has one) is refused, not run in a layout of its own."""
    cfg = dataclasses.replace(SMOKE, shared_attn_every=0, num_layers=2)
    with pytest.raises(NotImplementedError, match="shared block"):
        model.init(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="shared block"):
        model.count_params_analytic(cfg)


def test_launch_counts_of_a_prefill():
    """Every Mamba2 block calls linear_scan once: 38 calls in a zamba2-1.2b
    prefill, and the shared block runs 6 times (counted on the smoke
    config's layout by patching the scan)."""
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return ref.linear_scan_ref(*args)
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mamba, "linear_scan", counting)
        model.proxy_scores(m, _tokens(SMOKE, 2, 8, 0))
    n_super, per, tail = transformer.zamba_layout(SMOKE)
    assert len(calls) == n_super * per + tail == SMOKE.num_layers
    n_super, per, tail = transformer.zamba_layout(configs.get_config(ARCH))
    assert n_super * per + tail == 38 and n_super == 6


def test_count_params_analytic_matches_reference():
    for cfg, jcfg in ((configs.get_config(ARCH), jconfigs.get_config(ARCH)),
                      (SMOKE, JSMOKE)):
        assert model.count_params_analytic(cfg) \
            == jmodel.count_params_analytic(jcfg)
    assert configs.get_config(ARCH).param_count() == 1_169_424_384


def test_config_is_the_reference_config():
    assert dataclasses.asdict(configs.get_config(ARCH)) == dataclasses.asdict(
        jconfigs.get_config(ARCH))
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(JSMOKE)
