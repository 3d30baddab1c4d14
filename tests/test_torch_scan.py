"""The port's linear scan against the JAX package, on the CPU.

On the CPU the port's `linear_scan` runs its plain version, the exact
float32 recurrence. It is held against the Pallas kernel in interpret mode
and against the reference's own oracle (``backend="ref"``), at the
reference's shapes and tolerance (``tests/test_kernels.py``: atol 1e-4),
and against ``scan_ops.linear_scan_recurrent`` (atol = rtol = 1e-5: the
same recurrence, summed in another order) where the Pallas kernel's
log-decay floor breaks it (w = 0.05), at a ragged S and at S = 1. The
zamba2 model built on it is held in ``test_torch_zamba.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels.linear_scan import ops as jls_ops  # noqa: E402
from repro.models import scan_ops as jscan_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ops, ref  # noqa: E402

SCAN_TOL = dict(atol=1e-4, rtol=0)           # tests/test_kernels.py


def _scan_inputs(b, h, s, dk, dv, decay_shift, seed, w_const=None):
    """The reference test's law (tests/test_kernels.py ``_scan_inputs``),
    drawn with numpy: q, k, v normal at scale 0.5, w = sigmoid(normal +
    decay_shift) or `w_const`, u normal at scale 0.3."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, s, dk)).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32) * 0.5
    if w_const is None:
        w = 1 / (1 + np.exp(-(rng.standard_normal((b, h, s, dk))
                              + decay_shift)))
    else:
        w = np.full((b, h, s, dk), w_const)
    u = rng.standard_normal((h, dk)).astype(np.float32) * 0.3
    return q, k, v, w.astype(np.float32), u


def _port(q, k, v, w, u):
    o, st = ops.linear_scan(*(torch.from_numpy(x) for x in (q, k, v, w)),
                            None if u is None else torch.from_numpy(u))
    return o.numpy(), st.numpy()


# -- linear_scan -----------------------------------------------------------------

@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_linear_scan_matches_pallas_interpret(bonus, chunk):
    """The reference's kernel test, tests/test_kernels.py:74-86: shape
    (2, 2, 128, 16, 24), decays sigmoid(normal + 2.5), inside the Pallas
    kernel's envelope."""
    q, k, v, w, u = _scan_inputs(2, 2, 128, 16, 24, 2.5, chunk)
    uu = u if bonus else None
    got = _port(q, k, v, w, uu)
    want = jls_ops.linear_scan(*map(jnp.asarray, (q, k, v, w)),
                               None if uu is None else jnp.asarray(uu),
                               backend="interpret", chunk=chunk)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), **SCAN_TOL)


@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 128, 16, 24), (1, 2, 256, 16, 16),
                                   (1, 1, 128, 8, 8), (1, 2, 64, 64, 64)])
def test_linear_scan_matches_reference_oracle(bonus, shape):
    """Against ``backend="ref"`` (the exact recurrence), including the
    reference's envelope and out-of-envelope shapes and dk = dv = 64."""
    q, k, v, w, u = _scan_inputs(*shape, 0.0, sum(shape))
    uu = u if bonus else None
    got = _port(q, k, v, w, uu)
    want = jls_ops.linear_scan(*map(jnp.asarray, (q, k, v, w)),
                               None if uu is None else jnp.asarray(uu),
                               backend="ref")
    assert got[0].dtype == np.float32 and got[1].shape == shape[:2] + (
        shape[3], shape[4])
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), **SCAN_TOL)


@pytest.mark.parametrize("bonus", [False, True])
def test_linear_scan_is_exact_below_the_pallas_floor(bonus):
    """w = 0.05 (log w = -3.0, under the Pallas kernel's -2.5 floor): the
    port keeps the exact recurrence to float32 rounding, where the Pallas
    kernel (chunk 32) misses it by more than 1e-2."""
    q, k, v, w, u = _scan_inputs(1, 2, 128, 16, 16, 0.0, 5, w_const=0.05)
    uu = u if bonus else None
    got = _port(q, k, v, w, uu)
    want = jscan_ops.linear_scan_recurrent(
        *map(jnp.asarray, (q, k, v, w)),
        None if uu is None else jnp.asarray(uu))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), atol=1e-5, rtol=1e-5)
    floored, _ = jls_ops.linear_scan(
        *map(jnp.asarray, (q, k, v, w)),
        None if uu is None else jnp.asarray(uu), backend="interpret",
        chunk=32)
    assert np.abs(np.asarray(floored) - np.asarray(want[0])).max() > 1e-2


@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("s", [1, 37, 100])
def test_linear_scan_ragged_and_single_step(bonus, s):
    """Any S: the Pallas kernel asserts S % chunk == 0; the port masks the
    ragged last chunk, and S = 1 is one step from the zero state."""
    q, k, v, w, u = _scan_inputs(2, 3, s, 16, 24, 1.0, s)
    uu = u if bonus else None
    got = _port(q, k, v, w, uu)
    want = jscan_ops.linear_scan_recurrent(
        *map(jnp.asarray, (q, k, v, w)),
        None if uu is None else jnp.asarray(uu))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), atol=1e-5, rtol=1e-5)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 40), st.integers(1, 20), st.integers(1, 20),
       st.floats(1e-3, 1.0), st.booleans(), st.integers(0, 10_000))
def test_linear_scan_property_matches_recurrence(s, dk, dv, w_low, bonus,
                                                 seed):
    """Random S, dk, dv and decays down to `w_low` against the reference's
    exact recurrence."""
    q, k, v, w, u = _scan_inputs(1, 2, s, dk, dv, 0.0, seed)
    w = (w_low + (1 - w_low) * w).astype(np.float32)
    uu = u if bonus else None
    got = _port(q, k, v, w, uu)
    want = jscan_ops.linear_scan_recurrent(
        *map(jnp.asarray, (q, k, v, w)),
        None if uu is None else jnp.asarray(uu))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), atol=1e-5, rtol=1e-5)


def test_linear_scan_clips_w_as_the_model_path_does():
    """w outside [1e-6, 1] is clipped (``scan_ops.py:91``): w = 0 acts as
    1e-6 and w = 2 as 1."""
    q, k, v, w, u = _scan_inputs(1, 1, 20, 4, 4, 0.0, 1)
    w[..., ::2, :] = 0.0
    w[..., 1::4, :] = 2.0
    clipped = np.clip(w, 1e-6, 1.0)
    np.testing.assert_array_equal(_port(q, k, v, w, None)[0],
                                  _port(q, k, v, clipped, None)[0])


def test_linear_scan_float64_arbiter_agrees():
    """The plain version in float64 (the arbiter for long sequences on the
    card) agrees with its float32 run to float32 rounding."""
    q, k, v, w, u = (torch.from_numpy(x)
                     for x in _scan_inputs(1, 2, 300, 16, 16, 2.5, 9))
    o32, s32 = ref.linear_scan_ref(q, k, v, w, u)
    o64, s64 = ref.linear_scan_ref(q, k, v, w, u,
                                   compute_dtype=torch.float64)
    assert o64.dtype == torch.float32 and s64.dtype == torch.float64
    torch.testing.assert_close(o32, o64, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s32.double(), s64, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("change,match", [
    (dict(dk=65), "dk, dv <= 64"), (dict(dv=65), "dk, dv <= 64"),
    (dict(kshape=(1, 2, 8, 5)), "share a shape"),
    (dict(dtype=torch.float16), "share a dtype"),
    (dict(wdtype=torch.bfloat16), "w must be float32"),
    (dict(vdtype=torch.float16), "v must be one of"),
    (dict(ushape=(3, 4)), "u must be")])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    """The checks the wrapper runs before a launch on the card."""
    dk, dv = change.get("dk", 4), change.get("dv", 4)
    dt = change.get("dtype", torch.float32)
    q = torch.zeros(1, 2, 8, dk, dtype=dt)
    k = torch.zeros(change.get("kshape", (1, 2, 8, dk)))
    v = torch.zeros(1, 2, 8, dv, dtype=change.get("vdtype", torch.float32))
    u = torch.zeros(change.get("ushape", (2, dk)))
    w = k.to(change.get("wdtype", k.dtype))
    with pytest.raises(ValueError, match=match):
        ops._check(q, k, v, w, u)


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vdtype", [torch.bfloat16, torch.float32])
def test_wrapper_takes_bf16_or_float32_v(qdtype, vdtype):
    """The card's kernels take v in bf16 or float32 (o comes back in v's
    dtype), whatever q and k are."""
    q = torch.zeros(1, 2, 8, 4, dtype=qdtype)
    v = torch.zeros(1, 2, 8, 6, dtype=vdtype)
    ops._check(q, q, v, torch.zeros(1, 2, 8, 4), torch.zeros(2, 4))
    o, st = ops.linear_scan(q, q, v, torch.ones(1, 2, 8, 4))
    assert o.dtype == vdtype and st.dtype == torch.float32


def test_wrapper_refuses_mixed_devices():
    x = torch.zeros(1, 1, 2, 2)
    with pytest.raises(ValueError, match="one cuda device"):
        ops.linear_scan(x, x, x, x.to("meta"))


def test_port_is_finite_where_the_pallas_default_chunk_is_not():
    """The Pallas wrapper's default chunk of 128 (``ops.py:13``) with its
    floor sized for chunk 32: at w = 0.3, exp(-cumulative log decay)
    overflows float32 within a chunk and its output is not finite; the
    port's equals the reference's exact recurrence."""
    q, k, v, w, u = _scan_inputs(1, 2, 128, 16, 16, 0.0, 7, w_const=0.3)
    pallas, _ = jls_ops.linear_scan(*map(jnp.asarray, (q, k, v, w)))
    assert not np.isfinite(np.asarray(pallas)).all()
    got = _port(q, k, v, w, None)
    want = jscan_ops.linear_scan_recurrent(*map(jnp.asarray, (q, k, v, w)))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), atol=1e-5, rtol=1e-5)


# -- the chunked kernel's algebra and its route ------------------------------

def _chunked_f64(q, k, v, w, c):
    """The algebra of the chunked CUDA kernel (``csrc/linear_scan_chunked
    .cu``) in float64, for Mamba2's scalar decay per step (w read at dim
    0): chunks of c steps, the last padded with zero rows and decays of 1;
    in each, G = C Bᵀ, L[i, j] = a_{j+1} ··· a_i by running products down
    each column (no ratio, no log), din_i = a_0 · L[i, 0], dout_j =
    L[c-1, j], A = din_{c-1}, and

        o = (G ∘ L) X + diag(din) C S,   S <- A S + Bᵀ diag(dout) X.
    """
    f = torch.float64
    q, k, v = (torch.as_tensor(x).to(f) for x in (q, k, v))
    a = torch.as_tensor(w).to(f)[..., 0].clamp(ref.W_MIN, 1.0)
    b, h, s, dk = q.shape
    pad = -s % c
    q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    a = torch.nn.functional.pad(a, (0, pad), value=1.0)
    cols = torch.arange(c)
    state = torch.zeros(b, h, dk, v.shape[-1], dtype=f)
    out = []
    for t0 in range(0, s + pad, c):
        cq, ck, x, ac = (t[:, :, t0:t0 + c] for t in (q, k, v, a))
        lmat = torch.zeros(b, h, c, c, dtype=f)
        prev = torch.zeros(b, h, c, dtype=f)
        for i in range(c):
            prev = torch.where(cols < i, prev * ac[..., i, None],
                               (cols == i).to(f))
            lmat[..., i, :] = prev
        din = ac[..., :1] * lmat[..., :, 0]
        dout = lmat[..., c - 1, :]
        gmat = cq @ ck.transpose(-1, -2)
        out.append((gmat * lmat) @ x + din[..., None] * (cq @ state))
        state = din[..., -1, None, None] * state \
            + ck.transpose(-1, -2) @ (dout[..., None] * x)
    return torch.cat(out, dim=2)[:, :, :s], state


def _mamba_decays(b, h, s, dk, law, seed):
    """Decays (B,H,S) broadcast over dk as a stride-0 view: ``zamba2`` is
    exp(-softplus(normal · 0.88)), ``tiny early`` sets the first 8 steps
    of every 16 to 1e-6 and the rest near 1, ``one`` is exactly 1,
    ``mixed`` puts 1e-6 at a fifth of the steps."""
    rng = np.random.default_rng(seed)
    a = np.exp(-np.log1p(np.exp(rng.standard_normal((b, h, s)) * 0.88)))
    if law == "tiny early":
        a = np.where(np.arange(s) % 16 < 8, 1e-6, 1 - 1e-3 * rng.random(
            (b, h, s)))
    elif law == "one":
        a = np.ones((b, h, s))
    elif law == "mixed":
        a = np.where(rng.random((b, h, s)) < 0.2, 1e-6, a)
    return torch.from_numpy(a.astype(np.float32))[..., None].expand(
        b, h, s, dk)


@pytest.mark.parametrize("c", [16, 64])
@pytest.mark.parametrize("s,law", [(1, "zamba2"), (10, "zamba2"),
                                   (63, "tiny early"), (64, "zamba2"),
                                   (65, "mixed"), (100, "zamba2"),
                                   (130, "one"), (200, "tiny early")])
def test_chunked_algebra_equals_the_recurrence(c, s, law):
    """The chunk decomposition that the CUDA kernel computes equals the
    exact recurrence (the plain version in float64) to 1e-12 of the
    largest output, at S < c, S = 1, ragged S, decays down to 1e-6 (also
    1e-6 early in a chunk and near 1 after, where a log-space L loses
    accuracy) and decays of exactly 1."""
    b, h, dk, dv = 2, 3, 16, 8
    rng = np.random.default_rng(s * 7 + c)
    q, k = (torch.from_numpy(rng.standard_normal((b, h, s, dk))) for _ in
            range(2))
    v = torch.from_numpy(rng.standard_normal((b, h, s, dv)))
    w = _mamba_decays(b, h, s, dk, law, s + c)
    got = _chunked_f64(q, k, v, w, c)
    want = ref.linear_scan_ref(q, k, v, w, compute_dtype=torch.float64)
    for g, x in zip(got, want):
        x = x.double()
        err = float((g - x).abs().max())
        assert err <= 1e-12 * float(x.abs().max()), (err, law)


# -- the channel kernel's algebra ------------------------------------------

CHANNEL_CHUNK = 16       # steps a chunk of csrc/linear_scan.cu


def _channel_f64(q, k, v, w, u, c=CHANNEL_CHUNK):
    """The algebra of the channel CUDA kernel (``csrc/linear_scan.cu``) in
    float64, for a decay per channel: chunks of c steps, the last padded
    with zero rows and decays of 1; in each, per channel and by running
    products only (no ratio, no log), pre_i = w_0 ··· w_{i-1} (to w_i with
    u None), suf_j = w_{j+1} ··· w_{c-1}, A = w_0 ··· w_{c-1}, and down
    each row of M, M[i, j] = Σ_d q_id k_jd w_{j+1,d} ··· w_{i-1,d} for
    j < i (to w_i with u None), M[i, i] = q_i · (u ⊙ k_i) (q_i · k_i with
    u None); then

        o = (q ⊙ pre) S + M v,   S <- diag(A) S + (k ⊙ suf)ᵀ v.
    """
    f = torch.float64
    q, k, v = (torch.as_tensor(x).to(f) for x in (q, k, v))
    w = torch.as_tensor(w).to(f).clamp(ref.W_MIN, 1.0)
    b, h, s, dk = q.shape
    after = u is None
    bonus = torch.ones(h, dk, dtype=f) if after else torch.as_tensor(u).to(f)
    pad = -s % c
    q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    state = torch.zeros(b, h, dk, v.shape[-1], dtype=f)
    out = []
    for t0 in range(0, s + pad, c):
        cq, ck, x, cw = (t[:, :, t0:t0 + c] for t in (q, k, v, w))
        run, pre = torch.ones(b, h, dk, dtype=f), []
        for i in range(c):
            if after:
                run = run * cw[:, :, i]
            pre.append(run)
            if not after:
                run = run * cw[:, :, i]
        run, suf = torch.ones(b, h, dk, dtype=f), [None] * c
        for j in reversed(range(c)):
            suf[j] = run
            run = run * cw[:, :, j]
        mmat = torch.zeros(b, h, c, c, dtype=f)
        for i in range(c):
            mmat[..., i, i] = (cq[:, :, i] * bonus * ck[:, :, i]).sum(-1)
            t = cq[:, :, i] * cw[:, :, i] if after else cq[:, :, i]
            for j in range(i - 1, -1, -1):
                mmat[..., i, j] = (t * ck[:, :, j]).sum(-1)
                t = t * cw[:, :, j]
        out.append((cq * torch.stack(pre, 2)) @ state + mmat @ x)
        state = run[..., None] * state \
            + (ck * torch.stack(suf, 2)).transpose(-1, -2) @ x
    return torch.cat(out, dim=2)[:, :, :s], state


def _channel_decays(b, h, s, dk, law, seed):
    """Decays per channel (B,H,S,dk): ``rwkv`` is RWKV6's law
    exp(-exp(clip(w0 + 2 · normal, -20, 8))) with w0 in [-6, 1] per
    channel (underflowing to 0, clipped to 1e-6, and near 1);
    ``tiny early`` is 1e-6 in the first 8 steps of every 16 and near 1
    after, in the even channels, RWKV6's law in the odd; ``one`` is
    exactly 1; ``zero`` is 0 (clipped to 1e-6) in a third of the channels,
    RWKV6's law elsewhere."""
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(-6.0, 1.0, dk)
    a = np.exp(-np.exp(np.clip(w0 + 2 * rng.standard_normal((b, h, s, dk)),
                               -20.0, 8.0)))
    if law == "tiny early":
        early = (np.arange(s) % 16 < 8)[:, None] & (np.arange(dk) % 2 == 0)
        near = 1 - 1e-3 * rng.random((b, h, s, dk))
        a = np.where(np.arange(dk) % 2 == 0, np.where(early, 1e-6, near), a)
    elif law == "one":
        a = np.ones((b, h, s, dk))
    elif law == "zero":
        a = np.where(np.arange(dk) % 3 == 0, 0.0, a)
    return torch.from_numpy(a)


@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("s,law", [(1, "rwkv"), (10, "rwkv"),
                                   (15, "tiny early"), (16, "zero"),
                                   (17, "rwkv"), (37, "one"),
                                   (100, "tiny early"), (64, "zero")])
def test_channel_algebra_equals_the_recurrence(s, law, bonus):
    """The chunk decomposition that the channel CUDA kernel computes equals
    the exact recurrence (the plain version in float64) to 1e-12 of the
    largest output, with u and without, at S = 1, S < c, S = c - 1, c,
    c + 1 and ragged S, at decays per channel of 1e-6 early in a chunk and
    near 1 after, exactly 1, 0 (clipped to 1e-6) and RWKV6's law."""
    b, h, dk, dv = 2, 3, 16, 8
    rng = np.random.default_rng(s * 11 + len(law))
    q, k = (torch.from_numpy(rng.standard_normal((b, h, s, dk))) for _ in
            range(2))
    v = torch.from_numpy(rng.standard_normal((b, h, s, dv)))
    u = torch.from_numpy(rng.standard_normal((h, dk)) * 0.3) if bonus \
        else None
    w = _channel_decays(b, h, s, dk, law, s + 3)
    got = _channel_f64(q, k, v, w, u)
    want = ref.linear_scan_ref(q, k, v, w, u, compute_dtype=torch.float64)
    for g, x in zip(got, want):
        x = x.double()
        err = float((g - x).abs().max())
        assert err <= 1e-12 * float(x.abs().max()), (err, law)


def _mamba_views(b, h, s, n, hd, dtype=torch.bfloat16, dv_pad=0):
    """Mamba2's layout as `mamba_block` hands it over: B and C (B,S,N)
    shared by the heads and the decay (B,H,S) over N as stride-0 views, v
    a (B,S,H,hd) tensor seen as (B,H,S,hd)."""
    bc = torch.randn(b, s, 2 * n).to(dtype)
    v = torch.randn(b, s, h, hd + dv_pad)[..., :hd].transpose(1, 2)
    return (bc[..., n:][:, None].expand(b, h, s, n),
            bc[..., :n][:, None].expand(b, h, s, n), v,
            _mamba_decays(b, h, s, n, "zamba2", 0))


def test_route_takes_the_chunked_kernel_for_mamba2_views():
    """Mamba2's views (bf16 or float32 q, k, float32 v) go to the chunked
    kernel; a decay per state row, RWKV6's bonus u, a bf16 v and rows that
    16-byte copies cannot read go to the channel kernel."""
    q, k, v, w = _mamba_views(2, 4, 70, 64, 32)
    assert ops.route(q, k, v, w) == "chunked"
    assert ops.route(q.float(), k.float(), v, w) == "chunked"
    assert ops.route(q, k, v, w.contiguous()) == "channel"
    assert ops.route(q, k, v, w, torch.zeros(4, 64)) == "channel"
    assert ops.route(q, k, v.contiguous(), w) == "chunked"
    assert ops.route(q, k, v.to(torch.bfloat16), w) == "channel"
    assert ops.route(q.half(), k.half(), v, w) == "channel"
    q8, k8, v8, w8 = _mamba_views(1, 2, 9, 8, 8)
    assert ops.route(q8, k8, v8, w8) == "chunked"
    _, _, v6, _ = _mamba_views(1, 2, 9, 8, 6)
    assert ops.route(q8, k8, v6, w8) == "channel"        # 24-byte rows
    _, _, vpad, _ = _mamba_views(1, 2, 9, 8, 8, dv_pad=1)
    assert ops.route(q8, k8, vpad, w8) == "channel"      # 36-byte strides
    q12, k12, v12, w12 = _mamba_views(1, 2, 9, 12, 8)
    assert ops.route(q12, k12, v12, w12) == "channel"    # 24-byte rows


@pytest.mark.parametrize("vdtype", [torch.bfloat16, torch.float32])
def test_route_sends_rwkv6_views_to_the_channel_kernel(vdtype):
    """RWKV6's views as `time_mix` hands them over: r, k and v (B,S,H,hd)
    seen as (B,H,S,hd), a decay per channel in the same layout, the bonus
    u: the channel kernel, with v in the model's dtype; Mamba2's views
    beside them take the chunked kernel."""
    b, s, h, hd = 2, 40, 4, 64

    def heads(dtype):
        return torch.randn(b, s, h * hd).to(dtype).reshape(
            b, s, h, hd).transpose(1, 2)
    r, k, v, w = (heads(torch.bfloat16), heads(torch.bfloat16),
                  heads(vdtype), heads(torch.float32).sigmoid())
    assert ops.route(r, k, v, w, torch.zeros(h, hd)) == "channel"
    assert ops.route(r, k, v, w) == "channel"
    assert ops.route(*_mamba_views(b, h, s, 64, hd)) == "chunked"


def test_cpu_runs_the_plain_version_on_either_route():
    """On the CPU both routes run the plain recurrence and count no
    launch."""
    q, k, v, w = _mamba_views(1, 2, 40, 16, 8)
    before = (ops.launches.count, dict(ops.launches.routes))
    for ww in (w, w.contiguous()):
        got = ops.linear_scan(q, k, v, ww)
        want = ref.linear_scan_ref(q, k, v, ww)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    assert before == (ops.launches.count, dict(ops.launches.routes))
