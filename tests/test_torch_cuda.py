"""Tests that need an NVIDIA GPU (marked ``cuda``; they skip without one).

They import nothing of jax or the JAX package, so they run on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA kernels are held against their plain versions on the card, and
the card's engine against a CPU engine serving the same corpus state.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.core.engine import SelectionEngine
from repro_torch.core.oracle import array_oracle
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery
from repro_torch.data.synthetic import make_beta
from repro_torch.kernels.score_hist import ops as sh_ops
from repro_torch.kernels.score_hist import ref as sh_ref
from repro_torch.kernels.threshold_select import ops as ts_ops
from repro_torch.kernels.threshold_select import ref as ts_ref


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
