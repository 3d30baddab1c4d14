"""The port's RWKV6 model against the JAX package, on the CPU.

The model is rwkv6's smoke config in float32 (two blocks, d 64, four wkv
heads of 16), with the JAX package's own ``model.init(PRNGKey(0), cfg)``
weights carried across by `params_from_reference`; the mixing vectors
(mu_x, mu, cm_mu_k, cm_mu_r, zero at init) and the norm scales are
perturbed with seeded noise so that they are exercised. Decays run at the
init's w0 = -6 (w about 0.9975) and, faster, at w0 drawn from [-6, -0.5]
(w down to about 0.55).

Tolerances, float32 throughout:
* ``channel_mix`` (no scan): atol = rtol = 2e-5;
* downstream of the wkv scan (``time_mix``, ``rwkv_block``, the states a
  prefill ends in, ``apply_train`` logits): within 2e-5 of the largest
  output of the reference run on its exact recurrence
  (``linear_scan_recurrent`` patched in for ``linear_scan_chunked``, in the
  call only), and no farther from the reference's own chunked scan than
  that recurrence is, plus the same 2e-5. The port's prefill runs the exact
  recurrence step by step (the `linear_scan` kernel's plain version here,
  its channel route on the card);
* proxy scores: rtol 1e-4 (a score is exp of a logit difference).
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
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import scan_ops as jscan_ops  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ref as ls_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model, rwkv, transformer  # noqa: E402

ARCH = "rwkv6-7b"
SMOKE = configs.get_smoke_config(ARCH)
JSMOKE = jconfigs.get_smoke_config(ARCH)
TOL = 2e-5
_MIXES = ("mu_x", "mu", "cm_mu_k", "cm_mu_r")


def _reference_arrays(jcfg, seed=0, fast_decay=False):
    """The reference's init at PRNGKey(0) as numpy, its mixing vectors
    moved by N(0, 0.3²) and norm scales scaled by 1 + N(0, 0.2²) from
    `seed`; with `fast_decay` w0 drawn from U[-6, -0.5]."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "scale":
            return (a * (1 + 0.2 * rng.standard_normal(a.shape))).astype(
                a.dtype)
        if name in _MIXES:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "w0" and fast_decay:
            return rng.uniform(-6.0, -0.5, a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, jmodel.init(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(params=["init_decays", "fast_decays"])
def decays(request):
    """The decays the model tests run at: the init's w0 = -6, or w0 drawn
    from [-6, -0.5]."""
    return request.param


def _exact_scan(q, k, v, w, u=None, initial_state=None, chunk=64):
    return jscan_ops.linear_scan_recurrent(q, k, v, w, u, initial_state)


def _references(fn):
    """(exact, chunked): `fn()` (a pytree) with the reference's wkv scan
    on its exact recurrence (patched in, in this call only) and on its own
    chunked scan, as numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jscan_ops, "linear_scan_chunked", _exact_scan)
        exact = jax.tree.map(np.asarray, fn())
    return exact, jax.tree.map(np.asarray, fn())


def _close(got, refs, tol=TOL):
    """Within `tol` of the largest |output| of the reference's exact
    recurrence, and no farther from its chunked scan than that recurrence
    is, plus the same `tol`."""
    exact, chunked = refs
    got = got.numpy()
    atol = tol * np.abs(exact).max()
    assert got.shape == exact.shape and np.isfinite(got).all()
    assert np.isfinite(chunked).all()
    np.testing.assert_allclose(got, exact, rtol=0, atol=atol)
    assert np.all(np.abs(got - chunked) <= np.abs(exact - chunked) + atol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _hidden(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, SMOKE.d_model)).astype(np.float32)


def _block0(arrays):
    return jax.tree.map(lambda a: a[0], arrays["body"]["blocks"])


def _port(arrays):
    return model.params_from_reference(arrays, SMOKE, device="cpu")


# -- one block ----------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 64, 128])
def test_time_mix_matches_reference(decays, s):
    """y, the new shift state and the final wkv state, from zero states."""
    arrays = _reference_arrays(JSMOKE, s, decays == "fast_decays")
    x = _hidden(2, s, s)
    p = jax.tree.map(jnp.asarray, _block0(arrays))
    state = jrwkv.init_rwkv_state(JSMOKE, 2)
    exact, chunked = _references(lambda: jrwkv.time_mix(
        p, JSMOKE, jnp.asarray(x), state["shift_tm"], state["wkv"]))
    got = rwkv.time_mix(_port(arrays).body.blocks[0], SMOKE,
                        torch.from_numpy(x))
    for i in range(3):
        _close(got[i], (exact[i], chunked[i]))


@pytest.mark.parametrize("s", [1, 8, 64])
def test_channel_mix_matches_reference(s):
    arrays = _reference_arrays(JSMOKE, 3)
    x = _hidden(3, s, 10 + s)
    p = jax.tree.map(jnp.asarray, _block0(arrays))
    shift = np.random.default_rng(s).standard_normal(
        (3, SMOKE.d_model)).astype(np.float32)
    want = jrwkv.channel_mix(p, JSMOKE, jnp.asarray(x), jnp.asarray(shift))
    got = rwkv.channel_mix(_port(arrays).body.blocks[0], SMOKE,
                           torch.from_numpy(x), torch.from_numpy(shift))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("s", [8, 64, 128])
def test_rwkv_block_matches_reference(decays, s):
    """The block's output and every state it ends in."""
    arrays = _reference_arrays(JSMOKE, 1, decays == "fast_decays")
    x = _hidden(2, s, 20 + s)
    p = jax.tree.map(jnp.asarray, _block0(arrays))
    state = jrwkv.init_rwkv_state(JSMOKE, 2)
    exact, chunked = _references(
        lambda: jrwkv.rwkv_block(p, JSMOKE, jnp.asarray(x), state))
    got, got_state = rwkv.rwkv_block(_port(arrays).body.blocks[0], SMOKE,
                                     torch.from_numpy(x))
    _close(got, (exact[0], chunked[0]))
    assert set(got_state) == {"shift_tm", "shift_cm", "wkv"}
    for name in got_state:
        _close(got_state[name], (exact[1][name], chunked[1][name]))


def test_prefill_with_a_carried_state_raises():
    """A carried state steps one token; a prefill starts from zeros."""
    m = _port(_reference_arrays(JSMOKE))
    state = rwkv.init_rwkv_state(SMOKE, 2, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        rwkv.rwkv_block(m.body.blocks[0], SMOKE,
                        torch.from_numpy(_hidden(2, 4, 0)), state)


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("b,s", [(2, 8), (1, 64), (2, 128)])
def test_body_prefill_matches_reference(decays, b, s):
    arrays = _reference_arrays(JSMOKE, 2, decays == "fast_decays")
    x = _hidden(b, s, b * s)
    pos = np.tile(np.arange(s), (b, 1))
    body = jax.tree.map(jnp.asarray, arrays["body"])
    refs = _references(lambda: jtransformer.body_prefill(
        body, JSMOKE, jnp.asarray(x), jnp.asarray(pos))[0])
    _close(transformer.body_prefill(_port(arrays).body, SMOKE,
                                    torch.from_numpy(x),
                                    torch.from_numpy(pos))[0], refs)


@pytest.mark.parametrize("b,s", [(2, 8), (1, 64), (2, 128), (3, 1)])
def test_apply_train_logits_match_reference(decays, b, s):
    """Logits over the whole sequence; S = 1 is a one-token record (the
    reference's ``scan_ops.step`` branch, from its zero state)."""
    arrays = _reference_arrays(JSMOKE, 4, decays == "fast_decays")
    tokens = _tokens(SMOKE, b, s, b + s)
    params = jax.tree.map(jnp.asarray, arrays)
    refs = _references(lambda: jmodel.apply_train(
        params, JSMOKE, jnp.asarray(tokens))[0])
    got = model.apply_train(_port(arrays), tokens)
    assert got.dtype == torch.float32
    _close(got, refs)


@pytest.mark.parametrize("target,s", [(1, 8), (7, 64), (3, 128)])
def test_proxy_scores_match_reference(decays, target, s):
    arrays = _reference_arrays(JSMOKE, target, decays == "fast_decays")
    tokens = _tokens(SMOKE, 4, s, target)
    params = jax.tree.map(jnp.asarray, arrays)
    exact, chunked = _references(lambda: jserve.make_serve_prefill(
        JSMOKE, target)(params, {"tokens": jnp.asarray(tokens)}))
    m = _port(arrays)
    got = model.proxy_scores(m, tokens, target)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-4, atol=0)
    assert np.all(np.abs(got.numpy() - chunked)
                  <= np.abs(exact - chunked) + 1e-4 * exact)
    served = serve.make_serve_prefill(SMOKE, target)(m, {"tokens": tokens})
    np.testing.assert_array_equal(served.numpy(), got.numpy())


def test_prefill_runs_linear_scan_once_a_block_on_the_step_route():
    """Every RWKV6 block calls linear_scan once, with the bonus u and a
    decay per channel: 32 calls in an rwkv6-7b prefill, each on the
    channel kernel's route (`ls_ops.route`, a function of shapes, dtypes
    and strides, so it runs on CPU tensors)."""
    routes = []

    def counting(q, k, v, w, u=None):
        assert u is not None and w.stride(-1) == 1 and v.dtype == w.dtype \
            == torch.float32
        routes.append(ls_ops.route(q, k, v, w, u))
        return ls_ref.linear_scan_ref(q, k, v, w, u)
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rwkv, "linear_scan", counting)
        model.proxy_scores(m, _tokens(SMOKE, 2, 8, 0))
    assert routes == ["channel"] * SMOKE.num_layers
    assert configs.get_config(ARCH).num_layers == 32


@pytest.mark.parametrize("s", [1, 21])
def test_time_mix_hands_bf16_v_straight_to_the_scan(s):
    """A bf16 model's `time_mix` gives linear_scan v in bf16 and takes o
    back in bf16, with no cast either way: on the CPU the scan's o and
    state, and the block's output, are the same bits as with v cast to
    float32 before the scan and o cast back to bf16 after."""
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    m = model.init(cfg, generator=torch.Generator().manual_seed(5),
                   device="cpu")
    x = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    seen = []

    def straight(q, k, v, w, u=None):
        o, st = ls_ops.linear_scan(q, k, v, w, u)
        seen.append((v.dtype, o, st))
        return o, st

    def cast(q, k, v, w, u=None):
        o, st = ls_ops.linear_scan(q, k, v.float(), w, u)
        seen.append((v.dtype, o.to(v.dtype), st))
        return o.to(v.dtype), st
    got = {}
    for name, scan in (("straight", straight), ("cast", cast)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rwkv, "linear_scan", scan)
            got[name] = rwkv.time_mix(m.body.blocks[0], cfg, x)
    (v_dtype, o, st), (_, o_cast, st_cast) = seen
    assert v_dtype == o.dtype == torch.bfloat16
    assert torch.equal(o, o_cast) and torch.equal(st, st_cast)
    for a, b in zip(got["straight"], got["cast"]):
        assert torch.equal(a, b)


# -- init, weights, configs ---------------------------------------------------

def test_init_matches_reference_structure():
    """`init` and the carried reference weights have the same parameter
    names, shapes and dtypes, block by block."""
    arrays = _reference_arrays(JSMOKE)
    m = model.init(SMOKE, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    carried = _port(arrays)
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in carried.named_parameters()}
    assert len(m.body.blocks) == SMOKE.num_layers and hasattr(m, "head")


def test_init_laws_and_dtypes():
    """The reference's laws: w0 = -6, zero mixes, u N(0, 0.1²) and the
    mixes' second factors N(0, 0.01²); vectors float32 and matrices in
    cfg.dtype, as the reference's bf16 init has them."""
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16", d_model=256,
                              ssm_head_dim=64, rwkv_lora_dim=32)
    jcfg = dataclasses.replace(JSMOKE, dtype="bfloat16", d_model=256,
                               ssm_head_dim=64, rwkv_lora_dim=32)
    blk = model.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu").body.blocks[0]
    jblk = jax.tree.map(lambda a: a[0], jmodel.init(
        jax.random.PRNGKey(0), jcfg)["body"]["blocks"])
    for name, p in blk.named_parameters():
        j = jblk
        for part in name.split("."):
            j = j[part]
        assert p.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[j.dtype.name], name
        assert tuple(p.shape) == j.shape, name
    assert bool((blk.w0 == -6).all()) and not blk.mu.any()
    for p, std in ((blk.u, 0.1), (blk.maa_w2, 0.01), (blk.wd2, 0.01)):
        assert abs(float(p.float().std()) / std - 1) < 0.1


def test_params_from_reference_keeps_bf16():
    jcfg = dataclasses.replace(JSMOKE, dtype="bfloat16")
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    arrays = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  jcfg))
    m = model.params_from_reference(arrays, cfg, device="cpu")
    wr = m.body.blocks[1].wr
    assert wr.dtype == torch.bfloat16 and m.body.blocks[1].u.dtype \
        == torch.float32
    np.testing.assert_array_equal(
        wr.float().numpy(),
        arrays["body"]["blocks"]["wr"][1].astype(np.float32))


def test_count_params_analytic_matches_reference():
    full = configs.get_config(ARCH)
    for cfg, jcfg in ((full, jconfigs.get_config(ARCH)), (SMOKE, JSMOKE)):
        assert model.count_params_analytic(cfg) \
            == jmodel.count_params_analytic(jcfg)
    assert abs(full.param_count() - 7.6e9) / 7.6e9 < 0.05
    assert full.param_count() == 7_633_633_280


def test_config_is_the_reference_config():
    assert dataclasses.asdict(configs.get_config(ARCH)) == dataclasses.asdict(
        jconfigs.get_config(ARCH))
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(JSMOKE)
    long = configs.SHAPES_BY_NAME["long_500k"]
    assert configs.shape_applicable(configs.get_config(ARCH), long)[0]
