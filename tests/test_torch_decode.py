"""The port's decode against the JAX package's, and against its own
prefill, on the CPU.

The models are the reference's smoke configs of smollm-360m (dense),
zamba2-1.2b (hybrid Mamba2), rwkv6-7b (RWKV6), llama4-maverick (MoE in
interleaved pairs) and deepseek-v2 without MLA (MoE after a dense prefix;
its MLA decode is held in ``tests/test_torch_mla.py``) in float32, with
the JAX package's own ``model.init(PRNGKey(0), cfg)`` weights carried
across by `params_from_reference`; norm scales, the Mamba2 conv bias, D, dt_bias and
A_log and the RWKV6 mixing vectors are perturbed with seeded noise so that
they are exercised. Caches come from `init_caches` (zeros), or hold seeded
noise carried across by `caches_from_reference`.

Tolerances, float32 throughout:
* ``scan_ops.step``, ``_causal_conv`` with a tail, ``decode_attention``:
  atol = rtol = 2e-5 (the same float32 operations in another order);
* a block's step (``mamba_block`` with a state, ``gqa_decode``) and
  ``apply_decode`` against the reference's: every step's logits, and
  every cache and state after the last step, within 2e-5 of the largest
  |reference value| of that tensor;
* the port's decode against the port's prefill (``apply_train``), step by
  step: within 2e-5 of the largest |prefill logit| (the prefill runs the
  `linear_scan` and `flash_attention` kernels' plain versions here, the
  decode the plain step and attention).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import scan_ops as jscan_ops  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, mamba, model, scan_ops  # noqa: E402

TOL = 2e-5
ARCHS = ("smollm-360m", "zamba2-1.2b", "rwkv6-7b")
# the two MoE layouts: interleaved pairs and a dense prefix
MOE_ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v2-236b")
ALL = ARCHS + MOE_ARCHS
JSMOKE = {a: jconfigs.get_smoke_config(a) for a in ALL}
JSMOKE["deepseek-v2-236b"] = dataclasses.replace(
    JSMOKE["deepseek-v2-236b"], use_mla=False)
SMOKE = {a: ModelConfig(**dataclasses.asdict(c)) for a, c in JSMOKE.items()}
_SCALED = ("scale", "d_skip")
_SHIFTED = ("conv_b", "dt_bias", "a_log", "mu_x", "mu", "cm_mu_k",
            "cm_mu_r", "bq", "bk", "bv")


def _reference_arrays(arch, seed=0):
    """The reference's init at PRNGKey(0) as numpy, perturbed from
    `seed`: scales and D by 1 + N(0, 0.2²), biases, Mamba2 decays and
    RWKV6 mixes by N(0, 0.3²)."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name in _SCALED:
            return (a * (1 + 0.2 * rng.standard_normal(a.shape))).astype(
                a.dtype)
        if name in _SHIFTED:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, jmodel.init(jax.random.PRNGKey(0), JSMOKE[arch]))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _noise_caches(arch, b, s, seed):
    """The reference's float32 caches filled with seeded noise (the
    recurrent states at 0.3, so a step's decay and read both matter)."""
    rng = np.random.default_rng(seed)
    zeros = jmodel.init_caches(JSMOKE[arch], b, s, jnp.float32)
    return jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape))
                        .astype(np.float32), zeros)


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    return t.numpy()


def _flat(caches):
    """The port's caches in the reference's layout: stacked on the same
    leading axes, as numpy (bf16 kept)."""
    def stack(x):
        if isinstance(x, list):
            return jax.tree.map(lambda *a: np.stack(a),
                                *[stack(e) for e in x])
        if isinstance(x, dict):
            return {k: stack(v) for k, v in x.items()}
        return _numpy(x)
    return stack(caches)


def _assert_tree_close(got, want, tol=TOL):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=0, atol=tol * max(np.abs(w).max(), 1e-30)),
        got, want)


# -- the step and the block steps ---------------------------------------------

@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_step_matches_reference(bonus, dtype):
    """Both read conventions, against the reference's step compiled (as
    its ``apply_decode`` runs it); in bf16, k and v bf16 (RWKV6's), k·v in
    float32 (XLA drops the bf16 rounding the step's jnp would do op by
    op) and o cast to v's dtype. The new state is the given one, written
    in place."""
    rng = np.random.default_rng(int(bonus))
    b, h, dk, dv = 2, 3, 8, 5
    state = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    q, k, w = (rng.standard_normal((b, h, dk)).astype(np.float32)
               for _ in range(3))
    w = 1 / (1 + np.exp(-w - 2))
    v = rng.standard_normal((b, h, dv)).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32) if bonus else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want_state, want_o = jax.jit(jscan_ops.step)(
        jnp.asarray(state), jnp.asarray(q), jnp.asarray(k, jdt),
        jnp.asarray(v, jdt), jnp.asarray(w),
        None if u is None else jnp.asarray(u))
    args = (torch.from_numpy(q), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), torch.from_numpy(w),
            None if u is None else torch.from_numpy(u))
    carried = torch.from_numpy(state.copy())
    got_state, got_o = scan_ops.step(carried, *args)
    assert got_state is carried
    assert got_o.dtype == tdt and got_state.dtype == torch.float32
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("s", [1, 2, 5])
def test_causal_conv_with_a_tail_matches_reference(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    tail = rng.standard_normal((2, 3, 40)).astype(np.float32)
    want = jmamba._causal_conv(*map(jnp.asarray, (x, w, b, tail)))
    got = mamba._causal_conv(*map(torch.from_numpy, (x, w, b, tail)))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=TOL,
                                   rtol=TOL)


def test_mamba_block_with_a_state_matches_reference():
    """One token from a carried state (noise): the output, the new conv
    tail and SSM state, written into the given state in place."""
    arch = "zamba2-1.2b"
    cfg, jcfg = SMOKE[arch], JSMOKE[arch]
    arrays = _reference_arrays(arch, 1)
    p = jax.tree.map(lambda a: jnp.asarray(a[0, 0]),
                     arrays["body"]["mamba_super"])
    rng = np.random.default_rng(5)
    state = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape))
                         .astype(np.float32),
                         jmamba.init_mamba_state(jcfg, 3))
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    want, want_state = jmamba.mamba_block(p, jcfg, jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, state))
    blk = model.params_from_reference(arrays, cfg, device="cpu") \
        .body.mamba_super[0][0]
    carried = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    got, got_state = mamba.mamba_block(blk, cfg, torch.from_numpy(x),
                                       carried)
    assert got_state is carried
    _assert_tree_close({"x": got.numpy(), **{k: v.numpy() for k, v in
                                              got_state.items()}},
                       {"x": want, **want_state})
    with pytest.raises(ValueError, match="one token"):
        mamba.mamba_block(blk, cfg, torch.zeros(3, 2, cfg.d_model), carried)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(dtype):
    """Rows at their own positions, one before the cache (attends evenly)
    and one past its end (attends to all)."""
    rng = np.random.default_rng(0)
    b, s, h, kv, dh = 5, 37, 6, 2, 16
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, s, kv, dh)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 7, 36, -1, 50], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jattention.decode_attention(*(jnp.asarray(a, jdt)
                                         for a in (q, ck, cv)),
                                       jnp.asarray(pos))
    got = attention.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, ck, cv)),
        torch.from_numpy(pos).long())
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL if dtype == "float32" else 2 ** -8,
                               rtol=TOL if dtype == "float32" else 2 ** -8)


def test_decode_attention_blocks_equal_one_pass(monkeypatch):
    """The float32 products over blocks of cache positions: a block of 3
    positions and one of the whole cache agree."""
    rng = np.random.default_rng(1)
    q, ck, cv = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((2, 1, 4, 8), (2, 20, 2, 8), (2, 20, 2, 8)))
    pos = torch.tensor([4, 19])
    whole = attention.decode_attention(q, ck, cv, pos)
    monkeypatch.setattr(attention, "DECODE_BLOCK_ELEMS", 3 * 2 * 2 * 8)
    np.testing.assert_allclose(
        attention.decode_attention(q, ck, cv, pos).numpy(), whole.numpy(),
        atol=1e-6, rtol=1e-6)


def test_gqa_decode_clamps_the_cache_write_as_the_reference():
    """``dynamic_update_slice`` places its start as the reference runs it:
    a negative start counts from the end (pos + S), then the start is
    clamped into [0, S-1]. A row at pos >= S writes at S - 1, one at -3 at
    S - 3 and one at -12 at 0. The port writes the same rows of the cache,
    in place."""
    arch = "smollm-360m"
    cfg, jcfg = SMOKE[arch], JSMOKE[arch]
    arrays = _reference_arrays(arch, 2)
    p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                     arrays["body"]["blocks"]["attn"])
    s = 9
    cache = jax.tree.map(lambda a: a[0], _noise_caches(arch, 5, s, 3)
                         ["blocks"])
    x = np.random.default_rng(4).standard_normal(
        (5, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([2, 8, 9, -3, -12], np.int32)
    want, want_cache = jattention.gqa_decode(
        p, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(pos))
    blk = model.params_from_reference(arrays, cfg, device="cpu") \
        .body.blocks[0]
    carried = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, got_cache = attention.gqa_decode(blk.attn, cfg, torch.from_numpy(x),
                                          carried, torch.from_numpy(pos))
    assert got_cache is carried
    _assert_tree_close({"x": got.numpy(), **{k: v.numpy() for k, v in
                                              got_cache.items()}},
                       {"x": want, **want_cache})
    written = np.any(got_cache["k"].numpy() != cache["k"], axis=(2, 3))
    np.testing.assert_array_equal(np.argwhere(written),
                                  [[0, 2], [1, 8], [2, 8], [3, 6], [4, 0]])


# -- apply_decode -------------------------------------------------------------

def _decode_both(arch, caches_np, tokens, positions, seed):
    """Every step's logits and the caches after the last, of the reference
    (its layout, numpy) and of the port (the port's), decoding `tokens`
    (B,T) at `positions` (T,B) from `caches_np` (the reference's layout;
    None for `init_caches`)."""
    cfg, jcfg = SMOKE[arch], JSMOKE[arch]
    arrays = _reference_arrays(arch, seed)
    params = jax.tree.map(jnp.asarray, arrays)
    m = model.params_from_reference(arrays, cfg, device="cpu")
    b, t = tokens.shape
    s = 8
    if caches_np is None:
        jc = jmodel.init_caches(jcfg, b, s, jnp.float32)
        pc = model.init_caches(cfg, b, s, torch.float32, device="cpu")
    else:
        jc = jax.tree.map(jnp.asarray, caches_np)
        pc = model.caches_from_reference(caches_np, cfg, device="cpu")
    step = jserve.make_serve_decode(jcfg)
    serve_decode = serve.make_serve_decode(cfg)
    want, got = [], []
    for i in range(t):
        batch = {"tokens": tokens[:, i:i + 1], "pos": positions[i]}
        lo, jc = step(params, jax.tree.map(jnp.asarray, batch), jc)
        want.append(np.asarray(lo))
        lo, pc = serve_decode(m, batch, pc)
        assert lo.shape == (b, 1, cfg.vocab_size)
        assert lo.dtype == torch.float32
        got.append(lo.numpy())
    return (np.stack(want), jax.tree.map(np.asarray, jc)), \
        (np.stack(got), pc)


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("start", ["zeros", "noise"])
def test_apply_decode_matches_reference(arch, start):
    """Eight steps through `make_serve_decode`, rows at their own
    positions: from zeroed caches at positions t and t + 3 a row; from
    caches of noise at 8 positions with a row running past the end (its
    write clamped to position 7) and a row stepping back. The final
    caches against the reference's, carried across by
    `caches_from_reference`."""
    b = 3
    if start == "zeros":
        caches = None
        positions = np.array([[t, t + 3, t // 2] for t in range(8)],
                             np.int32)
    else:
        caches = _noise_caches(arch, b, 8, 7)
        positions = np.array([[t, 5 + t, 7 - t] for t in range(8)],
                             np.int32)
    tokens = _tokens(SMOKE[arch], b, 8, 11)
    (want, want_caches), (got, got_caches) = _decode_both(
        arch, caches, tokens, positions, 3)
    for i in range(len(want)):
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=TOL * np.abs(want[i]).max())
    # the reference's final caches carried into the port's layout
    carried = model.caches_from_reference(want_caches, SMOKE[arch],
                                          device="cpu")
    assert jax.tree.structure(got_caches) == jax.tree.structure(carried)
    for g, w in zip(jax.tree.leaves(got_caches), jax.tree.leaves(carried)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * max(float(w.abs().max()), 1e-30))


def _merge_row(dst, src, row):
    """Row `row` of every tensor of `dst` := row 0 of `src`'s."""
    if isinstance(dst, dict):
        for k in dst:
            _merge_row(dst[k], src[k], row)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _merge_row(d, s, row)
    else:
        dst[row] = src[0]


@pytest.mark.parametrize("arch", ALL)
def test_decode_reproduces_the_prefill(arch):
    """Each row's decode, from `init_caches`, reproduces `apply_train`'s
    logits at every position. Row r first decodes its own first
    offsets[r] tokens alone; its caches go into row r of one batch, which
    then steps all rows at once, each at its own position. An MoE model
    runs at capacity factor E, where neither the prefill (n = 3 · 14
    tokens) nor a step drops an assignment: the caches are tested, not
    the capacity."""
    cfg = SMOKE[arch]
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(
            cfg.num_experts))
    m = model.params_from_reference(_reference_arrays(arch, 5), cfg,
                                    device="cpu")
    offsets, t, s = (0, 3, 6), 8, 16
    tokens = _tokens(cfg, len(offsets), max(offsets) + t, 2)
    prefill = model.apply_train(m, tokens).numpy()
    caches = model.init_caches(cfg, len(offsets), s, torch.float32,
                               device="cpu")
    for r, off in enumerate(offsets):
        alone = model.init_caches(cfg, 1, s, torch.float32, device="cpu")
        for i in range(off):
            lo, alone = model.apply_decode(m, tokens[r:r + 1, i:i + 1],
                                           alone, [i])
            np.testing.assert_allclose(
                lo[0, 0].numpy(), prefill[r, i], rtol=0,
                atol=TOL * np.abs(prefill[r, i]).max())
        with torch.inference_mode():
            _merge_row(caches, alone, r)
    for i in range(t):
        pos = np.array(offsets) + i
        lo, caches = model.apply_decode(
            m, tokens[np.arange(len(offsets)), pos][:, None], caches, pos)
        want = prefill[np.arange(len(offsets)), pos]
        np.testing.assert_allclose(lo[:, 0].numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())


def test_decode_makes_no_host_sync(monkeypatch):
    """A step reads nothing back and branches on no tensor's value, so a
    later slice may capture it in a CUDA graph: the methods that would
    read a value to the host raise while each family decodes."""
    def refuse(*_a, **_k):
        raise AssertionError("host read of a tensor in a decode step")
    steps = {}
    for arch in ALL:
        cfg = SMOKE[arch]
        m = model.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
        steps[arch] = (m, model.init_caches(cfg, 2, 4, torch.float32,
                                            device="cpu"))
    tok, pos = torch.ones(2, 1, dtype=torch.long), torch.tensor([1, 3])
    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for m, caches in steps.values():
        model.apply_decode(m, tok, caches, pos)


# -- caches -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_init_caches_match_reference(arch, dtype):
    """The same entries, shapes and dtypes (bf16 by default, as the
    reference's), stacked as the reference stacks them; all zeros."""
    kw = {} if dtype is None else {"dtype": torch.float32}
    jkw = {} if dtype is None else {"dtype": jnp.float32}
    got = model.init_caches(SMOKE[arch], 3, 10, device="cpu", **kw)
    want = jmodel.init_caches(JSMOKE[arch], 3, 10, **jkw)

    def spec(a):
        return a.shape, a.dtype.name
    assert jax.tree.map(spec, _flat(got)) == jax.tree.map(spec, want)
    assert all(not t.any() and t.is_inference()
               for t in jax.tree.leaves(got))


def test_caches_from_init_caches_decode_two_steps():
    """`init_caches` and `apply_decode` agree on their mode: caches made by
    one are updated in place by the other, step after step."""
    cfg = SMOKE["rwkv6-7b"]
    m = model.init(cfg, generator=torch.Generator().manual_seed(1),
                   device="cpu")
    caches = model.init_caches(cfg, 2, 4, torch.float32, device="cpu")
    wkv = caches["blocks"][0]["wkv"]
    for i in range(2):
        _, out = model.apply_decode(m, [[1], [2]], caches, [i, i])
        assert out is caches and out["blocks"][0]["wkv"] is wkv
    assert bool(wkv.any())


def test_caches_from_reference_round_trip():
    """The reference's stacked caches, one entry per block and per
    invocation of the hybrid's shared block, back to the same arrays."""
    arch = "zamba2-1.2b"
    caches = _noise_caches(arch, 2, 5, 0)
    got = model.caches_from_reference(caches, SMOKE[arch], device="cpu")
    assert [len(s) for s in got["mamba_super"]] == [2, 2]
    assert len(got["shared_attn"]) == 2 and len(got["mamba_tail"]) == 1
    jax.tree.map(np.testing.assert_array_equal, _flat(got), caches)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_caches_from_reference_round_trip(arch):
    """The MoE layouts' stacked caches, a KV cache a block under ``dense``
    and ``moe`` (interleaved) or ``dense_prefix`` and ``moe_blocks``, back
    to the same arrays."""
    caches = _noise_caches(arch, 2, 5, 1)
    got = model.caches_from_reference(caches, SMOKE[arch], device="cpu")
    assert sorted(got) == sorted(caches)
    assert {k: len(v) for k, v in got.items()} == {
        k: v["k"].shape[0] for k, v in caches.items()}
    jax.tree.map(np.testing.assert_array_equal, _flat(got), caches)


def test_serve_decode_refuses_a_model_of_another_config():
    cfg = SMOKE["smollm-360m"]
    m = model.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    other = dataclasses.replace(cfg, name="other")
    caches = model.init_caches(cfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="model built for"):
        serve.make_serve_decode(other)(
            m, {"tokens": np.zeros((1, 1)), "pos": np.zeros(1)}, caches)


def test_init_caches_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_caches(SMOKE["rwkv6-7b"], 1, 4)
