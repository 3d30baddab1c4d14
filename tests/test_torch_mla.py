"""The port's MLA (DeepSeek-V2's multi-head latent attention) and the
deepseek-v2 model against the JAX package, on the CPU.

The model is deepseek-v2's smoke config (a dense block, then an MLA + MoE
block of 8 experts, top-2 softmax, one shared; MLA with q rank 32, latent
16, nope 16, rope 8, v 16), with ``q_lora_rank`` as configured and set to
0 (the query projected straight from x), in float32, with the JAX
package's own ``model.init(PRNGKey(0), cfg)`` weights carried across by
`params_from_reference`; norm scales are perturbed with seeded noise so
that they are exercised. The prefill's attention runs `flash_attention`'s
plain version here, at (dh, dv) = (24, 16); the card's kernel takes
(192, 128), deepseek-v2's own pair, and is held to the same plain version
in ``tests/test_torch_cuda.py``.

Tolerances, float32 throughout (the reference's own, as in
``tests/test_torch_models.py`` and ``tests/test_torch_decode.py``):
* ``_mla_q``, ``_mla_latent``, ``mla_prefill``, ``mla_decode`` and the
  plain attention at dv != dh: atol = rtol = 2e-5;
* logits after the full model, every decode step's logits and every cache
  after the last step: within 2e-5 of the largest |reference value|;
* proxy scores: rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, model  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
DSV2 = "deepseek-v2-236b"
Q_RANKS = (32, 0)          # the smoke config's q_lora_rank, and none


def _pair(q_rank=32, **change):
    """(port config, reference config) of deepseek-v2's smoke config with
    q_lora_rank `q_rank` and `change`."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(DSV2),
                               q_lora_rank=q_rank, **change)
    return ModelConfig(**dataclasses.asdict(jcfg)), jcfg


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


def _attn(arrays, cfg, block="moe_blocks"):
    """The first `block`'s attention parameters: the reference's (jnp) and
    the port's (carried by `params_from_reference`)."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      arrays["body"][block]["attn"])
    m = model.params_from_reference(arrays, cfg, device="cpu")
    return jp, getattr(m.body, block)[0].attn


def _hidden(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _positions(b, s, seed):
    """Each row's positions: a run from a random start (rope at positions
    other than 0..S-1)."""
    start = np.random.default_rng(seed).integers(0, 50, (b, 1))
    return (start + np.arange(s)).astype(np.int32)


# -- the MLA layer ------------------------------------------------------------

@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_init_mla_matches_reference_structure(q_rank):
    """The same parameter names, shapes and dtypes as the reference's
    ``init_mla``: w_dq, q_norm and w_uq with a q rank, wq without."""
    cfg, jcfg = _pair(q_rank, dtype="bfloat16")
    want = jax.tree.map(np.asarray, jattention.init_mla(
        jax.random.PRNGKey(0), jcfg))
    got = attention.init_mla(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    shapes = {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
              for n, t in got.named_parameters()}
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert shapes == {".".join(k.key for k in path):
                      (a.shape, a.dtype.name) for path, a in flat}
    assert ("w_uq" in shapes) == bool(q_rank) and ("wq" in shapes) != bool(
        q_rank)


@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_mla_q_and_latent_match_reference(q_rank):
    """q_nope, the rotated q_rope, the normed latent c and the rotated
    shared k_rope, at positions that do not start at 0."""
    cfg, jcfg = _pair(q_rank)
    jp, p = _attn(_reference_arrays(jcfg, 1), cfg)
    x, pos = _hidden(cfg, 2, 24, 2), _positions(2, 24, 3)
    want = (*jattention._mla_q(jp, jcfg, jnp.asarray(x), jnp.asarray(pos)),
            *jattention._mla_latent(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos)))
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    got = (*attention._mla_q(p, cfg, xt, pt),
           *attention._mla_latent(p, cfg, xt, pt))
    h = cfg.num_heads
    shapes = [(2, 24, h, cfg.qk_nope_head_dim),
              (2, 24, h, cfg.qk_rope_head_dim), (2, 24, cfg.kv_lora_rank),
              (2, 24, cfg.qk_rope_head_dim)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("s", [40, 33, 1])
@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_mla_prefill_matches_reference(q_rank, s):
    """(B,S,d) -> (B,S,d) through per-head k = [k_nope | k_rope] and v,
    causal attention at q's head dim dn + dr against v's dv."""
    cfg, jcfg = _pair(q_rank)
    jp, p = _attn(_reference_arrays(jcfg, 2), cfg)
    x, pos = _hidden(cfg, 2, s, 4), _positions(2, s, 5)
    want = jattention.mla_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    before = fa_ops.launches.count
    got = attention.mla_prefill(p, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    assert fa_ops.launches.count == before       # the plain version here
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_prefill_calls_flash_attention_at_dqk_and_dv(monkeypatch):
    """The prefill's attention goes through `flash_attention`, once, with
    q and k at dn + dr, v at dv, causal, and k's rotary part the same for
    every head."""
    cfg, jcfg = _pair()
    _, p = _attn(_reference_arrays(jcfg), cfg)
    seen = []
    real = attention.flash_attention

    def spy(q, k, v, *, causal=True):
        seen.append((q, k, v, causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(attention, "flash_attention", spy)
    x = torch.from_numpy(_hidden(cfg, 2, 12, 6))
    attention.mla_prefill(p, cfg, x, torch.arange(12).expand(2, 12))
    (q, k, v, causal), = seen
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    h = cfg.num_heads
    assert causal and q.shape == k.shape == (2, 12, h, dn + dr)
    assert v.shape == (2, 12, h, cfg.v_head_dim)
    assert all(t.is_contiguous() for t in (q, k, v))
    assert torch.equal(k[..., dn:], k[:, :, :1, dn:].expand(-1, -1, h, -1))


def _noise_cache(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"c": rng.standard_normal((b, s, cfg.kv_lora_rank)),
            "k_rope": rng.standard_normal((b, s, cfg.qk_rope_head_dim))}


@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_mla_decode_matches_reference(q_rank):
    """One token a row against a latent cache of noise, rows at their own
    positions: inside the cache, at its last position, past its end (the
    write clamped to S - 1), and negative (counted from the end, then
    clamped; the row attends to every position). The output and the cache
    written in place, against the reference's returned cache."""
    cfg, jcfg = _pair(q_rank)
    jp, p = _attn(_reference_arrays(jcfg, 3), cfg)
    s = 9
    cache = {k: v.astype(np.float32) for k, v in
             _noise_cache(cfg, 5, s, 7).items()}
    x = _hidden(cfg, 5, 1, 8)
    pos = np.array([2, 8, 9, -3, -12], np.int32)
    want, want_cache = jattention.mla_decode(
        jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(pos))
    carried = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, got_cache = attention.mla_decode(p, cfg, torch.from_numpy(x),
                                          carried, torch.from_numpy(pos))
    assert got_cache is carried and got.shape == (5, 1, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in cache:
        np.testing.assert_allclose(got_cache[k].numpy(),
                                   np.asarray(want_cache[k]), **TOL)
    written = np.any(got_cache["c"].numpy() != cache["c"], axis=2)
    np.testing.assert_array_equal(np.argwhere(written),
                                  [[0, 2], [1, 8], [2, 8], [3, 6], [4, 0]])


def test_mla_decode_blocks_equal_one_pass(monkeypatch):
    """The float32 scores and o_lat over blocks of cache positions: blocks
    of 3 positions and one of the whole cache agree."""
    cfg, jcfg = _pair()
    _, p = _attn(_reference_arrays(jcfg, 4), cfg)
    cache = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in _noise_cache(cfg, 2, 20, 9).items()}
    x, pos = torch.from_numpy(_hidden(cfg, 2, 1, 10)), torch.tensor([4, 19])

    def run():
        return attention.mla_decode(
            p, cfg, x, {k: v.clone() for k, v in cache.items()}, pos)[0]
    whole = run()
    monkeypatch.setattr(attention, "DECODE_BLOCK_ELEMS",
                        3 * 2 * (cfg.kv_lora_rank + cfg.qk_rope_head_dim))
    np.testing.assert_allclose(run().numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_mla_decode_bf16_cache_matches_reference():
    """A bf16 model and cache (the card's dtypes): the output within
    2^-7 of the largest |output| and the cache written bit for bit as the
    reference writes it."""
    cfg, jcfg = _pair(dtype="bfloat16")
    jp, p = _attn(_reference_arrays(jcfg, 5), cfg)
    cache = {k: v.astype(jnp.bfloat16) for k, v in
             _noise_cache(cfg, 3, 16, 11).items()}
    x = _hidden(cfg, 3, 1, 12).astype(jnp.bfloat16)
    pos = np.array([0, 7, 15], np.int32)
    want, want_cache = jattention.mla_decode(
        jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(pos))
    carried = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
               for k, v in cache.items()}
    got, got_cache = attention.mla_decode(
        p, cfg, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
        carried, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    for k in cache:
        np.testing.assert_array_equal(
            got_cache[k].float().numpy(),
            np.asarray(want_cache[k], np.float32))


def test_mla_cache_spec_matches_reference():
    cfg, jcfg = _pair()
    got = attention.mla_cache_spec(cfg, 3, 10, torch.bfloat16)
    want = jattention.mla_cache_spec(jcfg, 3, 10, jnp.bfloat16)
    assert {k: s for k, (s, _) in got.items()} == \
        {k: s for k, (s, _) in want.items()}
    assert all(dt == torch.bfloat16 for _, dt in got.values())


# -- flash_attention's plain version at dv != dh --------------------------------

@pytest.mark.parametrize("b,s,h,dh,dv,chunks", [
    (1, 128, 4, 192, 128, (64, 32)),    # deepseek-v2's head dims
    (2, 64, 3, 24, 16, (32, 16)),       # the smoke config's
    (1, 96, 2, 192, 128, (96, 96))])
def test_flash_attention_plain_dv_matches_chunked_causal_attention(
        b, s, h, dh, dv, chunks):
    """The plain version with v's own head dim, against the reference's
    ``chunked_causal_attention`` (MLA's prefill path there), which scales
    by 1/√dh of q too. (The TPU kernel takes dv = dh only;
    ``tests/test_torch_kernels.py`` holds the plain version against it in
    interpret mode.)"""
    rng = np.random.default_rng(s + dh)
    q, k = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    got = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (b, s, h, dv) and got.dtype == torch.float32
    want = jattention.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=chunks[0],
        kv_chunk=chunks[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class _CudaLooking:
    """A stand-in for a CUDA tensor of `shape` on a machine without a
    card."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 1 << 20


@pytest.mark.parametrize("dh,dv", [(192, 192), (192, 64), (128, 192),
                                   (64, 128), (128, 64), (256, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_refuses_other_head_dim_pairs(monkeypatch, dh, dv,
                                                      dtype):
    """A CUDA tensor of a (dh, dv) pair the kernel has no instance for
    raises a ValueError naming the pair, before any build: it never falls
    back to the plain version."""
    def refuse(name):
        raise AssertionError("built a kernel for a refused input")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(fa_ops, "_lib", fa_ops._lib.__wrapped__)
    q, k = (_CudaLooking((1, 8, 4, dh), dtype) for _ in range(2))
    with pytest.raises(ValueError, match=f"got \\({dh}, {dv}\\)"):
        fa_ops.flash_attention(q, k, _CudaLooking((1, 8, 4, dv), dtype))


@pytest.mark.parametrize("v_shape", [(1, 9, 4, 128), (1, 8, 2, 128),
                                     (2, 8, 4, 128), (8, 4, 128)])
def test_flash_attention_v_must_agree_with_k_but_its_head_dim(
        monkeypatch, v_shape):
    """v shares k's batch, sequence and KV heads."""
    monkeypatch.setattr(fa_ops, "_lib", fa_ops._lib.__wrapped__)
    q, k = (_CudaLooking((1, 8, 4, 192)) for _ in range(2))
    with pytest.raises(ValueError, match="v \\(B,S,KV,dv\\)"):
        fa_ops.flash_attention(q, k, _CudaLooking(v_shape))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_192_128_launches_or_raises(monkeypatch, dtype):
    """At (192, 128) CUDA tensors go to the kernel and nowhere else: with no
    kernel to load the wrapper raises."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel here")

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(fa_ops, "_lib", fa_ops._lib.__wrapped__)
    q, k = (_CudaLooking((2, 100, 8, 192), dtype) for _ in range(2))
    with pytest.raises(RuntimeError, match="kernel here"):
        fa_ops.flash_attention(q, k, _CudaLooking((2, 100, 8, 128), dtype))


def test_bf16_launch_plan_at_192_128():
    """deepseek-v2's prefill: one q buffer and two ring stages, 48 KB of q
    and 80 KB a stage (209 KB with the alignment slack, within a CTA's
    227 KB), and v's tensor map at its own head dim."""
    b, s, h = 4, 4096, 128
    q = torch.empty(b, s, h, 192, dtype=torch.bfloat16, device="meta")
    v = torch.empty(b, s, h, 128, dtype=torch.bfloat16, device="meta")
    plan = fa_ops.bf16_launch_plan(q, q, v, sms=132)
    assert plan["smem_bytes"] == 2 * (128 * 192 + 2 * 128 * 320) + 1024 \
        == 214_016
    assert plan["smem_bytes"] <= 232_448 - 128
    assert plan["work"] == 32 * h * b and plan["ctas"] == 132
    assert plan["k_geom"] == plan["q_geom"] == (
        192, h, s, b, 2 * 192, 2 * h * 192, 2 * s * h * 192)
    assert plan["v_geom"] == (128, h, s, b, 256, 2 * h * 128,
                              2 * s * h * 128)


# -- the deepseek-v2 model ------------------------------------------------------

def test_deepseek_v2_is_registered_as_the_reference_config():
    for get in ("get_config", "get_smoke_config"):
        got = getattr(configs, get)(DSV2)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            getattr(jconfigs, get)(DSV2))
    assert DSV2 in configs.ARCH_IDS and len(configs.ARCH_IDS) == 10


@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_init_matches_reference_structure(q_rank):
    """`init` and the carried reference weights: the same parameter names,
    shapes and dtypes, the dense prefix and the MLA + MoE blocks."""
    cfg, jcfg = _pair(q_rank)
    m = model.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    carried = model.params_from_reference(_reference_arrays(jcfg), cfg,
                                          device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in carried.named_parameters()}
    assert "body.moe_blocks.0.attn.w_dkv" in shapes


@pytest.mark.parametrize("b,s", [(2, 40), (1, 33)])
@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_apply_train_logits_match_reference(q_rank, b, s):
    cfg, jcfg = _pair(q_rank)
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


def test_serve_prefill_scores_match_reference():
    cfg, jcfg = _pair()
    arrays = _reference_arrays(jcfg)
    tokens = _tokens(cfg, 4, 20, 1)
    want = jserve.make_serve_prefill(jcfg)(jax.tree.map(jnp.asarray, arrays),
                                           {"tokens": jnp.asarray(tokens)})
    m = model.params_from_reference(arrays, cfg, device="cpu")
    got = serve.make_serve_prefill(cfg)(m, {"tokens": tokens})
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=0)


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_init_caches_match_reference(dtype):
    """Latent caches {'c', 'k_rope'} a block, under ``dense_prefix`` and
    ``moe_blocks``, bf16 by default, as the reference's stacks them."""
    cfg, jcfg = _pair()
    kw = {} if dtype is None else {"dtype": torch.float32}
    jkw = {} if dtype is None else {"dtype": jnp.float32}
    got = model.init_caches(cfg, 3, 10, device="cpu", **kw)
    want = jmodel.init_caches(jcfg, 3, 10, **jkw)
    assert sorted(got) == sorted(want) == ["dense_prefix", "moe_blocks"]
    for name, entries in got.items():
        assert len(entries) == want[name]["c"].shape[0]
        for e in entries:
            assert sorted(e) == ["c", "k_rope"]
            for k, t in e.items():
                w = want[name][k]
                assert tuple(t.shape) == w.shape[1:]
                assert str(t.dtype).split(".")[-1] == w.dtype.name
                assert not t.any() and t.is_inference()


def _noise_caches(jcfg, b, s, seed):
    rng = np.random.default_rng(seed)
    zeros = jmodel.init_caches(jcfg, b, s, jnp.float32)
    return jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape))
                        .astype(np.float32), zeros)


@pytest.mark.parametrize("start", ["zeros", "noise"])
@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_apply_decode_matches_reference(q_rank, start):
    """Eight steps through `make_serve_decode`, rows at their own
    positions: from zeroed caches, or from the reference's caches of noise
    carried across by `caches_from_reference` with a row running past the
    end and one stepping back. Every step's logits and the final caches
    against the reference's."""
    cfg, jcfg = _pair(q_rank)
    arrays = _reference_arrays(jcfg, 3)
    params = jax.tree.map(jnp.asarray, arrays)
    m = model.params_from_reference(arrays, cfg, device="cpu")
    b, s = 3, 8
    if start == "zeros":
        jc = jmodel.init_caches(jcfg, b, s, jnp.float32)
        pc = model.init_caches(cfg, b, s, torch.float32, device="cpu")
        positions = np.array([[t, t + 3, t // 2] for t in range(8)],
                             np.int32)
    else:
        caches = _noise_caches(jcfg, b, s, 7)
        jc = jax.tree.map(jnp.asarray, caches)
        pc = model.caches_from_reference(caches, cfg, device="cpu")
        positions = np.array([[t, 5 + t, 7 - t] for t in range(8)],
                             np.int32)
    tokens = _tokens(cfg, b, 8, 11)
    step = jserve.make_serve_decode(jcfg)
    serve_decode = serve.make_serve_decode(cfg)
    for i in range(8):
        batch = {"tokens": tokens[:, i:i + 1], "pos": positions[i]}
        want, jc = step(params, jax.tree.map(jnp.asarray, batch), jc)
        got, pc = serve_decode(m, batch, pc)
        want = np.asarray(want)
        assert got.shape == (b, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    carried = model.caches_from_reference(jax.tree.map(np.asarray, jc), cfg,
                                          device="cpu")
    assert jax.tree.structure(pc) == jax.tree.structure(carried)
    for g, w in zip(jax.tree.leaves(pc), jax.tree.leaves(carried)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2e-5 * max(float(w.abs().max()),
                                                   1e-30))


@pytest.mark.parametrize("q_rank", Q_RANKS)
def test_decode_reproduces_the_prefill(q_rank):
    """Each row's absorbed decode from `init_caches` reproduces
    `apply_train`'s logits (the materialized prefill) at every position,
    rows at their own positions, at capacity factor E (no drops)."""
    cfg, jcfg = _pair(q_rank)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    m = model.params_from_reference(_reference_arrays(jcfg, 5), cfg,
                                    device="cpu")
    offsets, t = (0, 3, 6), 8
    tokens = _tokens(cfg, len(offsets), max(offsets) + t, 2)
    prefill = model.apply_train(m, tokens).numpy()
    caches = model.init_caches(cfg, len(offsets), 16, torch.float32,
                               device="cpu")
    rows = np.arange(len(offsets))
    with torch.inference_mode():
        for r, off in enumerate(offsets):     # earlier positions, row alone
            alone = model.init_caches(cfg, 1, 16, torch.float32,
                                      device="cpu")
            for i in range(off):
                model.apply_decode(m, tokens[r:r + 1, i:i + 1], alone, [i])
            for name, entries in caches.items():
                for e, a in zip(entries, alone[name]):
                    for k in e:
                        e[k][r] = a[k][0]
    for i in range(t):
        pos = np.array(offsets) + i
        lo, caches = model.apply_decode(m, tokens[rows, pos][:, None],
                                        caches, pos)
        want = prefill[rows, pos]
        np.testing.assert_allclose(lo[:, 0].numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


# -- counts -------------------------------------------------------------------

_COUNTED = {"published": configs.get_config(DSV2),
            "smoke": configs.get_smoke_config(DSV2),
            "smoke-without-q-rank": _pair(0)[0],
            "published-cut-to-8": dataclasses.replace(
                configs.get_config(DSV2), num_layers=8)}


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("case", list(_COUNTED))
def test_count_params_analytic_matches_reference(case, active):
    """The MLA branch of the count: equal to the reference's formula in
    both modes, and the configs' own counts too."""
    cfg = _COUNTED[case]
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    want = jmodel.count_params_analytic(jcfg, active_only=active)
    assert model.count_params_analytic(cfg, active_only=active) == want
    assert (cfg.active_param_count() if active else cfg.param_count()) \
        == want


def test_deepseek_v2_counts():
    """The published config's 235.7e9 parameters, 21.4e9 active; MLA's
    149.2e6 a layer, and the smoke model's count is what it holds (its
    norms aside)."""
    cfg = configs.get_config(DSV2)
    mla = dataclasses.replace(cfg, moe=False, first_k_dense=0, num_layers=1,
                              dense_d_ff=0, d_ff=0, vocab_size=0)
    assert model.count_params_analytic(mla) == 149_225_472
    assert cfg.param_count() == 235_740_692_480
    assert cfg.active_param_count() == 21_375_057_920
    smoke = configs.get_smoke_config(DSV2)
    m = model.init(smoke, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    held = sum(p.numel() for n, p in m.named_parameters()
               if not n.endswith("scale"))
    assert held == smoke.param_count()
