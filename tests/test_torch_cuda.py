"""Tests that need an NVIDIA GPU (marked ``cuda``; they skip without one).

They import nothing of jax or the JAX package, so they run on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA kernels are held against their plain versions on the card, the
card's engine against a CPU engine serving the same corpus state, and a
narrow model's scores (float32) and logits (bf16) through the
flash_attention kernel against the same model with attention by the plain
version.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import random as R
from repro_torch.core.engine import SelectionEngine
from repro_torch.core.oracle import array_oracle
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery
from repro_torch.data.synthetic import make_beta
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.score_hist import ops as sh_ops
from repro_torch.kernels.score_hist import ref as sh_ref
from repro_torch.kernels.threshold_select import ops as ts_ops
from repro_torch.kernels.threshold_select import ref as ts_ref
from repro_torch.models import attention, model


def _scores(n, seed, sentinel_frac=0.01):
    rng = np.random.default_rng(seed)
    s = rng.beta(0.1, 1.0, n).astype(np.float32)
    s[rng.random(n) < sentinel_frac] = -1.0
    return s


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,bins", [(1 << 22, 4096), (1 << 22, 64),
                                    (777, 4096), (5, 64),
                                    (100_000, sh_ops.MAX_BINS), (3000, 1)])
def test_score_hist_kernel_matches_plain(card, n, bins):
    s = torch.from_numpy(_scores(n, 7)).to(card)
    got = sh_ops.score_hist(s, bins)
    again = sh_ops.score_hist(s, bins)
    plain = sh_ref.score_hist_ref(s, bins)
    torch.cuda.synchronize()
    assert torch.equal(got[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, p in zip(got[1:], plain[1:]):
        torch.testing.assert_close(g, p, rtol=4e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1000, 2048, 2049, 1 << 22])
@pytest.mark.parametrize("tau", [0.0, 0.5, 0.999, 1.01])
def test_threshold_select_kernel_matches_plain(card, n, tau):
    s = torch.from_numpy(_scores(n, 3)).to(card)
    got = ts_ops.threshold_select(s, tau)
    torch.cuda.synchronize()
    assert torch.equal(got, ts_ref.threshold_select_ref(s, tau))


@pytest.mark.cuda
def test_card_engine_matches_cpu_engine(card):
    """From one corpus state the card's engine (kernels) and a CPU engine
    (plain versions) return the same tau, counts and indices."""
    ds = make_beta(300_000, 0.01, 1.0, seed=5)
    shards = np.array_split(ds.scores, 3)
    oracle = array_oracle(ds.labels)
    queries = [SUPGQuery(target="recall", gamma=0.9, budget=2000),
               SUPGQuery(target="precision", gamma=0.8, budget=2000),
               JointSUPGQuery(gamma_recall=0.8, stage_budget=2000)]
    with SelectionEngine(shards, num_bins=4096, chunk_records=1 << 15,
                         device="cpu") as cpu, \
            SelectionEngine.from_state(cpu._state, device=card,
                                       workers=4) as gpu:
        for q in queries:
            run = "run_joint" if isinstance(q, JointSUPGQuery) else "run"
            a = getattr(cpu, run)(R.PRNGKey(1), oracle, q)
            b = getattr(gpu, run)(R.PRNGKey(1), oracle, q)
            assert a.tau == b.tau
            np.testing.assert_array_equal(a.shard_counts, b.shard_counts)
            for i in range(3):
                np.testing.assert_array_equal(a.indices(i), b.indices(i))


def _plain_attention(q, k, v, causal=True):
    """flash_attention's plain version in the kernel's (B,S,H,dh) layout."""
    return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal).transpose(1, 2)


# bf16 bar of flash_attention against its plain version, chip_smoke.py's
# (whose note gives the reason and the measurement): each output within
# 5e-3 + 2^-7 |plain| (one bf16 ulp for the two roundings of the output,
# plus p's rounding to bf16 before p·v, where the products cancel), and
# the whole within 5e-3 of ||plain||.
BF16_RTOL, BF16_ATOL, BF16_FRO_TOL = 2.0 ** -7, 5e-3, 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,dh", [(2, 256, 8, 2, 64),
                                         (1, 128, 6, 1, 128),
                                         (2, 1000, 15, 5, 64),
                                         (3, 77, 6, 3, 128),
                                         (1, 1, 2, 1, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_matches_plain(card, b, s, h, kv, dh, causal,
                                              dtype):
    """Within the bf16 bar above, or in float32 within the reference's own
    kernel-vs-ref tolerance (tests/test_kernels.py, 2e-5); bitwise
    identical across launches."""
    g = torch.Generator(device=card).manual_seed(s + h)
    q = torch.randn(b, s, h, dh, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, kv, dh, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, kv, dh, generator=g, device=card).to(dtype)
    before = fa_ops.launches.count
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    again = fa_ops.flash_attention(q, k, v, causal=causal)
    plain = _plain_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa_ops.launches.count == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        plain = plain.float()
        torch.testing.assert_close(got.float(), plain, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)
        assert float((got.float() - plain).norm()) \
            <= BF16_FRO_TOL * float(plain.norm())
    else:
        torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_narrow_model_scores_through_the_kernel_match_plain(card,
                                                            monkeypatch):
    """A two-layer float32 model at head_dim 64: one kernel launch a layer,
    and scores within rtol 1e-4 of attention by the plain version (the
    tolerance of the CPU parity tests against the JAX package)."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-360m"),
                              d_model=192, num_heads=3, num_kv_heads=1,
                              head_dim=64, d_ff=256, vocab_size=512)
    g = torch.Generator(device=card).manual_seed(0)
    m = model.init(cfg, generator=g, device=card)
    tokens = np.random.default_rng(0).integers(0, 512, (8, 100))
    before = fa_ops.launches.count
    got = model.proxy_scores(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    monkeypatch.setattr(attention, "flash_attention", _plain_attention)
    want = model.proxy_scores(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_narrow_bf16_model_logits_through_the_kernel_match_plain(
        card, monkeypatch, seed):
    """The same narrow model in bf16: last-position logits within 6e-3 of
    their largest magnitude of attention by the plain version. bf16 rounds
    each layer's output, and the kernel's roundings differ from the plain
    version's at a few outputs; over these seeds this model measured 1.3e-3
    to 2.1e-3 on an H100, as far as the same model with plain attention
    lies from its float32 copy. The tolerance is three times the largest."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-360m"),
                              d_model=192, num_heads=3, num_kv_heads=1,
                              head_dim=64, d_ff=256, vocab_size=512,
                              dtype="bfloat16")
    g = torch.Generator(device=card).manual_seed(seed)
    m = model.init(cfg, generator=g, device=card)
    tokens = np.random.default_rng(seed).integers(0, 512, (8, 100))
    before = fa_ops.launches.count
    got = model.last_logits(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    monkeypatch.setattr(attention, "flash_attention", _plain_attention)
    want = model.last_logits(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) \
        <= 6e-3 * float(want.abs().max())
