"""The port's kernel wrappers: plain versions against the JAX package on
the CPU, and dispatch by tensor device. The CUDA kernels themselves are
held against their plain versions on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from repro.kernels.score_hist import ops as jsh_ops
from repro.kernels.score_hist.ref import score_hist_ref as jscore_hist_ref
from repro.kernels.threshold_select import ops as jts_ops
from repro.kernels.threshold_select.ref import threshold_select_ref as jts_ref
from repro_torch.kernels import _build
from repro_torch.kernels.score_hist import ops as sh_ops
from repro_torch.kernels.score_hist import ref as sh_ref
from repro_torch.kernels.threshold_select import ops as ts_ops
from repro_torch.kernels.threshold_select import ref as ts_ref


def _scores(n, seed, sentinel_frac=0.01):
    rng = np.random.default_rng(seed)
    s = rng.beta(0.1, 1.0, n).astype(np.float32)
    s[rng.random(n) < sentinel_frac] = -1.0
    return s


# -- score_hist, plain version vs the JAX package ---------------------------

@pytest.mark.parametrize("n,bins", [(4096, 512), (10_000, 4096), (777, 512),
                                    (5000, 64), (3000, 4096)])
def test_score_hist_plain_matches_reference(n, bins):
    """Counts and sums equal the reference scatter-add bit for bit (both
    add in record order in float32)."""
    s = _scores(n, n + bins)
    got = sh_ops.score_hist(torch.from_numpy(s), bins)
    want = jscore_hist_ref(s, bins)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (bins,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,bins", [(4096, 512), (10_000, 4096), (777, 512)])
def test_score_hist_plain_matches_pallas_interpret(n, bins):
    """Against the Pallas kernel in interpret mode: counts exact, sums
    within the reference's own kernel-vs-ref bar (atol 1e-3,
    tests/test_kernels.py)."""
    s = _scores(n, n)
    got = sh_ops.score_hist(torch.from_numpy(s), bins)
    want = jsh_ops.score_hist(s, bins, backend="interpret", block_n=1024)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)


def test_score_hist_ignores_sentinel_and_clips():
    s = torch.tensor([-1.0, 0.0, 0.5, 1.0, 1.5, -1.0])
    counts, sum_w, sum_a = sh_ops.score_hist(s, 4)
    assert counts.tolist() == [1.0, 0.0, 1.0, 2.0]
    assert sum_a.tolist() == [0.0, 0.0, 0.5, 2.0]
    assert float(counts.sum()) == 4.0


# -- threshold_select, plain version vs the JAX package ---------------------

@pytest.mark.parametrize("n", [1, 777, 1024, 2049, 4096, 10_000])
@pytest.mark.parametrize("tau", [0.0, 0.3, 0.999, 1.0, 1.01, -0.5])
def test_threshold_select_plain_matches_reference(n, tau):
    rng = np.random.default_rng(n)
    s = rng.random(n).astype(np.float32)
    s[rng.integers(0, n, max(n // 10, 1))] = -1.0
    got = ts_ops.threshold_select(torch.from_numpy(s), tau)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jts_ref(s, tau))
    if n % 512 == 0:
        np.testing.assert_array_equal(
            got.numpy(), jts_ops.threshold_select(s, tau,
                                                  backend="interpret"))
    assert np.all(np.diff(got.numpy()) > 0)
    assert got.numel() == int(((s >= tau) & (s >= 0)).sum())


def test_threshold_select_never_selects_sentinel():
    s = torch.tensor([-1.0, 0.0, 0.5, -1.0, 1.0])
    for tau in (0.0, -1.0, float("-inf")):
        assert ts_ops.threshold_select(s, tau).tolist() == [1, 2, 4]


def test_threshold_select_edge_cases():
    assert ts_ops.threshold_select(torch.empty(0), 0.5).numel() == 0
    assert ts_ops.threshold_select(torch.full((2048,), 0.9), 0.5).tolist() \
        == list(range(2048))
    assert ts_ops.threshold_select(torch.full((2048,), 0.1), 0.5).numel() == 0


def test_threshold_select_compares_in_float32():
    """tau is rounded to float32 once, as the reference's numpy compare
    rounds a Python float against a float32 array."""
    s = np.asarray([0.5, 0.7], np.float32)
    tau = 0.5000000002
    np.testing.assert_array_equal(
        ts_ops.threshold_select(torch.from_numpy(s), tau).numpy(),
        jts_ref(s, tau))


def test_threshold_select_memmap_chunk(tmp_path):
    p = tmp_path / "chunk.f32"
    arr = np.memmap(p, np.float32, "w+", shape=(5000,))
    arr[:] = np.random.default_rng(1).random(5000)
    chunk = torch.from_numpy(np.array(arr[1000:3000]))
    np.testing.assert_array_equal(
        ts_ops.threshold_select(chunk, 0.7).numpy(),
        jts_ref(arr[1000:3000], 0.7))


# -- dispatch by tensor device -----------------------------------------------

def test_cpu_tensor_never_touches_the_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU path loaded the {name} kernel")

    monkeypatch.setattr(_build, "load", refuse)
    before = (sh_ops.launches.count, ts_ops.launches.count)
    s = torch.from_numpy(_scores(3000, 0))
    sh_ops.score_hist(s, 64)
    ts_ops.threshold_select(s, 0.5)
    assert (sh_ops.launches.count, ts_ops.launches.count) == before


class _CudaLooking:
    """A stand-in for a CUDA tensor on a machine without a card."""

    device = torch.device("cuda", 0)
    dtype = torch.float32

    def dim(self):
        return 1

    def is_contiguous(self):
        return True

    def numel(self):
        return 8


@pytest.mark.parametrize("call", [
    lambda t: sh_ops.score_hist(t, 64),
    lambda t: ts_ops.threshold_select(t, 0.5)])
def test_cuda_tensor_launches_or_raises(monkeypatch, call):
    """A CUDA tensor goes to the kernel and nowhere else: with no kernel
    to load the wrapper raises instead of computing the plain version."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel here")

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(sh_ref, "score_hist_ref", None)
    monkeypatch.setattr(ts_ref, "threshold_select_ref", None)
    with pytest.raises(RuntimeError, match="kernel here"):
        call(_CudaLooking())


@pytest.mark.parametrize("bins", [0, sh_ops.MAX_BINS + 1])
def test_score_hist_kernel_refuses_bins_beyond_shared_memory(bins):
    """The kernel takes any bin count whose 20 B/bin fit a CTA's shared
    memory and raises above it, before any build or launch."""
    with pytest.raises(ValueError, match="num_bins"):
        sh_ops.score_hist(_CudaLooking(), bins)


@pytest.mark.parametrize("call", [
    lambda t: sh_ops.score_hist(t, 64),
    lambda t: ts_ops.threshold_select(t, 0.5)])
def test_other_devices_and_layouts_raise(call):
    with pytest.raises(ValueError):
        call(torch.zeros(8, device="meta"))
