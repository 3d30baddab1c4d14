"""The port's kernel wrappers: plain versions against the JAX package on
the CPU, and dispatch by tensor device.

flash_attention's plain version is held against the JAX package's kernel in
interpret mode and against its ``backend="ref"`` at the reference's own
tolerances (tests/test_kernels.py): atol = rtol = 2e-5 in float32, 2e-2 in
bf16. Its logsumexp (the forward's `lse`, which the backward takes) is
held against `jax.nn.logsumexp` of the reference's masked, scaled scores.
The CUDA kernels themselves are held against their plain versions on the
card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jfa_ops  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref  # noqa: E402
from repro.kernels.score_hist import ops as jsh_ops  # noqa: E402
from repro.kernels.score_hist.ref import score_hist_ref as jscore_hist_ref  # noqa: E402
from repro.kernels.threshold_select import ops as jts_ops  # noqa: E402
from repro.kernels.threshold_select.ref import threshold_select_ref as jts_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.score_hist import ops as sh_ops  # noqa: E402
from repro_torch.kernels.score_hist import ref as sh_ref  # noqa: E402
from repro_torch.kernels.threshold_select import ops as ts_ops  # noqa: E402
from repro_torch.kernels.threshold_select import ref as ts_ref  # noqa: E402


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


@pytest.mark.parametrize("n", [1, 777, 5000])
def test_score_hist_masses_on_the_cpu_match_the_reference(n):
    """On the CPU `masses` receives the chunk's float64 Σ sqrt(clip(A))
    and Σ clip(A) of the plain version, within float64 reordering
    (rel 1e-12) of the JAX package's chunk masses, and the sketch is the
    plain one, bit for bit."""
    from repro.core import binned as jbinned
    s = _scores(n, 3 * n)
    masses = torch.full((2,), np.nan, dtype=torch.float64)
    got = sh_ops.score_hist(torch.from_numpy(s), 64, masses=masses)
    _, js_sqrt, js_a = jbinned.chunk_sketch_stats(s, 64, use_kernel=False)
    assert torch.equal(masses, sh_ref.chunk_masses_ref(torch.from_numpy(s)))
    np.testing.assert_allclose(masses.numpy(), [js_sqrt, js_a], rtol=1e-12)
    for g, w in zip(got, sh_ref.score_hist_ref(torch.from_numpy(s), 64)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("masses", [
    lambda: torch.empty(2, dtype=torch.float32),
    lambda: torch.empty(3, dtype=torch.float64),
    lambda: torch.empty(4, dtype=torch.float64)[::2],
    lambda: torch.empty(2, dtype=torch.float64, device="meta")])
def test_score_hist_refuses_masses_it_cannot_write(masses):
    """`masses` must be a contiguous (2,) float64 tensor on the scores'
    device, on the CPU path as on the card's."""
    with pytest.raises(ValueError, match="masses"):
        sh_ops.score_hist(torch.from_numpy(_scores(100, 1)), 64,
                          masses=masses())


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


@pytest.mark.parametrize("n", [1, 777, 1024, 2049, 4096, 10_000])
@pytest.mark.parametrize("tau", [0.0, 0.3, 0.999, 1.0, 1.01, -0.5])
def test_threshold_count_plain_matches_reference(n, tau):
    """The count is the length of the JAX package's selection, by its
    numpy reference and, where the Pallas kernel takes the length, by the
    kernel in interpret mode."""
    rng = np.random.default_rng(n + 1)
    s = rng.random(n).astype(np.float32)
    s[rng.integers(0, n, max(n // 10, 1))] = -1.0
    got = ts_ops.threshold_count(torch.from_numpy(s), tau)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == jts_ref(s, tau).size
    if n % 512 == 0:
        assert int(got) == jts_ops.threshold_select(
            s, tau, backend="interpret").size


def test_threshold_count_edge_cases():
    assert int(ts_ops.threshold_count(torch.empty(0), 0.5)) == 0
    assert int(ts_ops.threshold_count(torch.full((4097,), 0.9), 0.5)) \
        == 4097
    s = torch.tensor([-1.0, 0.0, 0.5, -1.0, 1.0])
    for tau in (0.0, -1.0, float("-inf")):
        assert int(ts_ops.threshold_count(s, tau)) == 3


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
    ts_ops.threshold_count(s, 0.5)
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
    lambda t: ts_ops.threshold_select(t, 0.5),
    lambda t: ts_ops.threshold_count(t, 0.5)])
def test_cuda_tensor_launches_or_raises(monkeypatch, call):
    """A CUDA tensor goes to the kernel and nowhere else: with no kernel
    to load the wrapper raises instead of computing the plain version."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel here")

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(sh_ref, "score_hist_ref", None)
    monkeypatch.setattr(ts_ref, "threshold_select_ref", None)
    monkeypatch.setattr(ts_ref, "threshold_count_ref", None)
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
    lambda t: ts_ops.threshold_select(t, 0.5),
    lambda t: ts_ops.threshold_count(t, 0.5)])
def test_other_devices_and_layouts_raise(call):
    with pytest.raises(ValueError):
        call(torch.zeros(8, device="meta"))


# -- flash_attention, plain version vs the JAX package -----------------------

def _qkv(b, s, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, kv, dh)).astype(np.float32),
            rng.standard_normal((b, s, kv, dh)).astype(np.float32))


@pytest.mark.parametrize("b,h,kv,s,dh", [
    (1, 4, 4, 128, 64),     # MHA
    (2, 8, 2, 256, 64),     # GQA group 4
    (1, 6, 1, 128, 128),    # MQA
    (1, 15, 5, 128, 64),    # GQA group 3 at smollm-360m's head_dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_reference(b, h, kv, s, dh, causal):
    q, k, v = _qkv(b, s, h, kv, dh, s + h)
    got = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
    assert got.shape == (b, s, h, dh) and got.dtype == torch.float32
    for backend in ("interpret", "ref"):
        want = jfa_ops.flash_attention(q, k, v, causal=causal,
                                       backend=backend, block_q=64,
                                       block_k=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kv", [1, 2])
def test_flash_attention_plain_bf16_matches_reference(kv):
    """Both packages round the same float32 draws to bf16, compute in
    float32 and round the output to bf16."""
    q, k, v = _qkv(1, 128, 4, kv, 64, kv)
    got = fa_ops.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    for backend in ("interpret", "ref"):
        want = jfa_ops.flash_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            backend=backend, block_q=64, block_k=64)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("s", [1, 77, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ragged_matches_reference(s, causal):
    """Sequence lengths the Pallas kernel refuses (S % block != 0), against
    the reference's ref.attention_ref in its (B,H,S,dh) layout."""
    q, k, v = _qkv(2, s, 6, 2, 64, s)
    got = fa_ref.attention_ref(
        *(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)), causal)
    want = jattention_ref(*(x.transpose(0, 2, 1, 3) for x in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    via_ops = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal)
    np.testing.assert_array_equal(via_ops.numpy(),
                                  got.transpose(1, 2).numpy())


# The plain lse against jax.nn.logsumexp of the reference's scores
# (ref.attention_ref's einsum, scale and -1e30 mask), float32, from the same
# numpy inputs: rtol 2e-6 (a few float32 ulps of the sum's log), and atol
# 1e-6 for rows whose lse lies near 0 (causal row 0 is its one score, whose
# 64-term dot products the two einsums sum in other orders).
LSE_RTOL, LSE_ATOL = 2e-6, 1e-6


@pytest.mark.parametrize("s", [77, 200])
@pytest.mark.parametrize("h,kv", [(3, 3), (6, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_jax_logsumexp(s, h, kv, causal):
    q, k, v = _qkv(2, s, h, kv, 64, s + h)
    o, lse = fa_ref.attention_ref(
        *(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)), causal,
        return_lse=True)
    qg = jnp.asarray(q.transpose(0, 2, 1, 3)).reshape(2, kv, h // kv, s, 64)
    scores = jnp.einsum("bkgqd,bkpd->bkgqp", qg,
                        jnp.asarray(k.transpose(0, 2, 1, 3))) / 8.0
    if causal:
        scores = jnp.where(jnp.tril(jnp.ones((s, s), bool)), scores, -1e30)
    want = jax.nn.logsumexp(scores, axis=-1).reshape(2, h, s)
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want),
                               rtol=LSE_RTOL, atol=LSE_ATOL)
    np.testing.assert_array_equal(
        o.numpy(), fa_ref.attention_ref(
            *(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
            causal).numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fwd_on_cpu_is_the_plain_o_and_lse(causal):
    q, k, v = map(torch.from_numpy, _qkv(2, 50, 6, 2, 64, 3))
    o, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal)
    want_o, want_lse = fa_ref.attention_ref(
        *(x.transpose(1, 2) for x in (q, k, v)), causal, return_lse=True)
    assert torch.equal(o, want_o.transpose(1, 2))
    assert torch.equal(lse, want_lse)
    assert torch.equal(o, fa_ops.flash_attention(q, k, v, causal=causal))


def test_flash_attention_cpu_never_touches_the_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU path loaded the {name} kernel")

    monkeypatch.setattr(_build, "load", refuse)
    before = fa_ops.launches.count
    fa_ops.flash_attention(*map(torch.from_numpy, _qkv(1, 16, 2, 1, 64, 0)))
    assert fa_ops.launches.count == before


class _CudaLookingQKV:
    """A stand-in for a (B,S,H,dh) CUDA tensor on a machine without a
    card."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.bfloat16, contiguous=True,
                 ptr=1 << 20):
        self.shape, self.dtype = torch.Size(shape), dtype
        self._contiguous, self._ptr = contiguous, ptr

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_cuda_tensor_launches_or_raises(monkeypatch, dtype):
    """CUDA tensors go to the kernel and nowhere else: with no kernel to
    load the wrapper raises instead of computing the plain version, on
    the bf16 and the float32 entry point alike."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel here")

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(fa_ops, "_lib", fa_ops._lib.__wrapped__)
    monkeypatch.setattr(fa_ref, "attention_ref", None)
    q = _CudaLookingQKV((2, 100, 15, 64), dtype)
    kv = _CudaLookingQKV((2, 100, 5, 64), dtype)
    with pytest.raises(RuntimeError, match="kernel here"):
        fa_ops.flash_attention(q, kv, kv)


@pytest.mark.parametrize("q,kv", [
    (_CudaLookingQKV((1, 8, 4, 96)), _CudaLookingQKV((1, 8, 4, 96))),
    (_CudaLookingQKV((1, 8, 4, 64), torch.float16),
     _CudaLookingQKV((1, 8, 4, 64), torch.float16)),
    (_CudaLookingQKV((1, 8, 4, 64)), _CudaLookingQKV((1, 8, 3, 64))),
    (_CudaLookingQKV((1, 8, 4, 64)), _CudaLookingQKV((1, 9, 4, 64))),
    (_CudaLookingQKV((1, 8, 4, 64)),
     _CudaLookingQKV((1, 8, 4, 64), torch.float32)),
    (_CudaLookingQKV((1, 8, 4, 64), contiguous=False),
     _CudaLookingQKV((1, 8, 4, 64))),
    (_CudaLookingQKV((1, 8, 4, 64), ptr=(1 << 20) + 2),
     _CudaLookingQKV((1, 8, 4, 64))),
    (_CudaLookingQKV((1, 0, 4, 64)), _CudaLookingQKV((1, 0, 4, 64))),
    (_CudaLookingQKV((8, 4, 64)), _CudaLookingQKV((8, 4, 64))),
])
def test_flash_attention_refuses_what_the_kernel_does_not_take(
        monkeypatch, q, kv):
    """Head dims other than 64/128 (with v at the same head dim; the
    (192, 128) pair has its tests in tests/test_torch_mla.py), other
    dtypes, H % KV != 0, mismatched shapes or dtypes, non-contiguous or
    misaligned tensors and an empty sequence raise before any build or
    launch."""
    def refuse(name):
        raise AssertionError("built a kernel for a refused input")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(fa_ops, "_lib", fa_ops._lib.__wrapped__)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, kv, kv)


def test_flash_attention_other_devices_raise():
    q = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or on one cuda"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cpu or on one cuda"):
        fa_ops.flash_attention(torch.zeros(1, 8, 2, 64), q, q)


# -- flash_attention's bf16 launch plan ---------------------------------------

@pytest.mark.parametrize("b,s,h,kv,dh", [
    (4, 4096, 15, 5, 64),      # smollm-360m prefill
    (256, 128, 32, 32, 64),    # zamba2-1.2b's shared block, scoring
    (2, 1000, 8, 1, 128),      # ragged S, MQA, head_dim 128
    (1, 1, 2, 1, 64),
    (4, 4096, 128, 128, 192)])  # deepseek-v2's MLA prefill, v dim 128
def test_flash_bf16_launch_plan(b, s, h, kv, dh):
    """Work tiles of 128 query rows for every head and batch, one
    persistent CTA an SM (fewer where there is less work), 384 threads,
    the dynamic shared memory of the q buffers and the ring's k and v
    tiles (2 and 4 at head_dim 64, 1 and 3 at 128, 1 and 2 at (192, 128);
    plus the 1024-byte alignment slack) within a CTA's 227 KB less its
    barriers, and tensor maps over (head dim, heads, S, batch) with the
    tensors' byte strides, each a multiple of the 16 bytes TMA needs; v's
    at its own head dim."""
    dv = {192: 128}.get(dh, dh)
    q = torch.empty(b, s, h, dh, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, kv, dh, dtype=torch.bfloat16, device="meta")
    v = torch.empty(b, s, kv, dv, dtype=torch.bfloat16, device="meta")
    plan = fa_ops.bf16_launch_plan(q, k, v, sms=132)
    assert plan["work"] == -(-s // 128) * h * b
    assert plan["ctas"] == min(plan["work"], 132)
    assert plan["threads"] == 384
    assert plan["smem_bytes"] == {64: 164_864, 128: 230_400,
                                  192: 214_016}[dh]
    assert plan["smem_bytes"] <= 232_448 - 128
    assert plan["q_geom"] == (dh, h, s, b, 2 * dh, 2 * h * dh,
                              2 * s * h * dh)
    assert plan["k_geom"] == (dh, kv, s, b, 2 * dh, 2 * kv * dh,
                              2 * s * kv * dh)
    assert plan["v_geom"] == (dv, kv, s, b, 2 * dv, 2 * kv * dv,
                              2 * s * kv * dv)
    assert all(x % 16 == 0 for name in ("q_geom", "k_geom", "v_geom")
               for x in plan[name][4:])


@pytest.mark.parametrize("b,s,h,kv,dh,dv", [
    (4, 4096, 15, 5, 64, 64),      # smollm-360m training
    (4, 4096, 24, 24, 64, 64),     # musicgen-medium training
    (2, 1000, 12, 2, 64, 64),      # ragged S, GQA 6
    (1, 1, 2, 1, 64, 64),
    (4, 4096, 32, 4, 128, 128),    # yi-6b training
    (2, 1000, 12, 2, 128, 128),
    (4, 4096, 128, 128, 192, 128),  # deepseek-v2's MLA training
    (1, 200, 4, 2, 192, 128)])
def test_flash_bwd_launch_plan(b, s, h, kv, dh, dv):
    """The bf16 backward's launches: dq over 128-row query tiles of every
    head and batch, dk and dv over 128-key tiles of every KV head and batch
    (one launch for both at head dim 64, one each at the wider pairs), each
    one CTA an SM up to its work, 384 threads; dq's key stages (64 keys,
    32 at dh 192) and dv's and dk's query stages (64 rows, 32 for dk at dh
    192) with the dynamic shared memory of their rings, within a CTA's
    227 KB less its barriers; lse and D in rows of S rounded up to 128;
    tensor maps of q, k and v from their strides and of dO as a contiguous
    (B, S, H, dv), each stride a multiple of 16 bytes."""
    q = torch.empty(b, s, h, dh, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, kv, dh, dtype=torch.bfloat16, device="meta")
    v = torch.empty(b, s, kv, dv, dtype=torch.bfloat16, device="meta")
    plan = fa_ops.bwd_launch_plan(q, k, v, sms=132)
    assert plan["dq_work"] == -(-s // 128) * h * b
    assert plan["dkdv_work"] == -(-s // 128) * kv * b
    assert plan["dq_ctas"] == min(plan["dq_work"], 132)
    assert plan["dkdv_ctas"] == min(plan["dkdv_work"], 132)
    assert plan["threads"] == 384
    assert plan["s_pad"] == fa_ops.lse_rows(s) == -(-s // 128) * 128
    assert plan["dkdv_launches"] == (1 if dh == 64 else 2)
    assert plan["dq_keys"] == {64: 64, 128: 64, 192: 32}[dh]
    assert plan["kv_rows"] == {64: (64, 64), 128: (64, 64),
                               192: (64, 32)}[dh]
    smem = (plan["dq_smem_bytes"], plan["dv_smem_bytes"],
            plan["dk_smem_bytes"])
    assert smem == {64: (132_096, 103_424, 103_424),
                    128: (230_400, 202_752, 201_728),
                    192: (205_824, 218_112, 211_968)}[dh]
    assert max(smem) <= 232_448 - 128
    assert plan["q_geom"] == fa_ops.tensor_map_geometry(q)
    assert plan["k_geom"] == (dh, kv, s, b, 2 * dh, 2 * kv * dh,
                              2 * s * kv * dh)
    assert plan["v_geom"] == (dv, kv, s, b, 2 * dv, 2 * kv * dv,
                              2 * s * kv * dv)
    assert plan["do_geom"] == fa_ops.tensor_map_geometry(
        torch.empty(b, s, h, dv, dtype=torch.bfloat16, device="meta"))
    assert all(x % 16 == 0 for name in ("q_geom", "k_geom", "v_geom",
                                        "do_geom")
               for x in plan[name][4:])


def test_check_lse_takes_only_the_forwards_layout():
    """The backward reads lse as rows lse_rows(S) apart: the forward's
    (B, H, S) view of its (B, H, lse_rows(S)) buffer passes; a missing
    lse, another shape or dtype, or rows S apart where S is not a
    multiple of 128 raise."""
    dev = torch.device("cpu")
    view = torch.randn(2, 3, 256)[:, :, :200]
    fa_ops._check_lse(view, 2, 3, 200, dev)
    fa_ops._check_lse(torch.randn(2, 3, 256), 2, 3, 256, dev)
    for bad in (None, view[:, :2], view.double(), view.contiguous(),
                view[..., :199]):
        with pytest.raises(ValueError, match="forward's lse"):
            fa_ops._check_lse(bad, 2, 3, 200, dev)


class _CudaLookingAny(_CudaLookingQKV):
    """A stand-in CUDA tensor that `flash_attention_bwd` can make
    contiguous."""

    def contiguous(self):
        return self


def test_flash_attention_bwd_on_cuda_tensors_needs_the_lse(monkeypatch):
    """CUDA tensors with no lse raise before any build or launch."""
    def refuse(name):
        raise AssertionError("built a kernel for a refused input")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(fa_ops, "_bwd_lib", fa_ops._bwd_lib.__wrapped__)
    q = _CudaLookingAny((2, 100, 6, 64))
    kv = _CudaLookingAny((2, 100, 2, 64))
    before = fa_ops.bwd_launches.count
    with pytest.raises(ValueError, match="forward's lse"):
        fa_ops.flash_attention_bwd(q, kv, kv, q, q)
    assert fa_ops.bwd_launches.count == before


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_check_rejects_strided_views(which):
    """The kernel writes o in q's contiguous (B, S, H, dh) order, so the
    wrapper takes only contiguous q, k and v: a (B, S, H, dh) view of a
    (B, H, S, dh) tensor is refused before any launch."""
    t = {name: torch.zeros(2, 100, 8, 64, dtype=torch.bfloat16)
         for name in "qkv"}
    t[which] = torch.zeros(2, 8, 100, 64,
                           dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops._check(t["q"], t["k"], t["v"])
    fa_ops._check(*(x.contiguous() for x in (t["q"], t["k"], t["v"])))


# -- keys longer than queries (context parallelism) --------------------------

@pytest.mark.parametrize("dh,dv", [(64, 64), (128, 128), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_with_longer_keys_matches_the_full_rows(dh, dv,
                                                              causal):
    """`ref.attention_ref` on query rows [lo, S) against all S keys (row i
    at position lo + i) equals those rows of the call over all S rows,
    its lse too, within 1e-6 (float32 sums over a different count of
    masked zeros); so does the plain backward's dq. It is the plain
    version the card's check of context-parallel attention uses."""
    g = torch.Generator().manual_seed(dh + causal)
    q = torch.randn(2, 4, 300, dh, generator=g)
    k = torch.randn(2, 2, 300, dh, generator=g)
    v = torch.randn(2, 2, 300, dv, generator=g)
    do = torch.randn(2, 4, 300, dv, generator=g)
    o, lse = fa_ref.attention_ref(q, k, v, causal, return_lse=True)
    dq = fa_ref.attention_bwd_ref(q, k, v, o, do, causal)[0]
    for lo in (0, 1, 128, 299):
        got, got_lse = fa_ref.attention_ref(q[:, :, lo:], k, v, causal,
                                            return_lse=True)
        assert (got - o[:, :, lo:]).abs().max() <= 1e-6
        assert (got_lse - lse[:, :, lo:]).abs().max() <= 1e-6
        got_dq = fa_ref.attention_bwd_ref(q[:, :, lo:], k, v, got,
                                          do[:, :, lo:], causal)[0]
        assert (got_dq - dq[:, :, lo:]).abs().max() <= 1e-6
    if causal:
        with pytest.raises(ValueError, match="Sk >= S"):
            fa_ref.attention_ref(q, k[:, :, :100], v[:, :, :100], causal)
