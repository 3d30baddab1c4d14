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
    (dict(vdtype=torch.bfloat16), "v and w must be float32"),
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
