"""linear_scan's gradient on the CPU: the plain backward
(`ref.linear_scan_bwd_ref`) and the autograd path of `ops.linear_scan`.

* Against PyTorch's autograd through `ref.linear_scan_ref` in float64, at
  rel 1e-12 of each gradient's largest |value| (the same arithmetic in
  another order);
* against ``jax.vjp`` of the reference's ``scan_ops.linear_scan_chunked``
  (what its training differentiates) in float32, each gradient within
  2e-5 of its largest |value| (the reference logits' bar,
  ``tests/test_torch_models.py``): Mamba2's stride-0 views (the heads'
  gradients summed by autograd) and RWKV6 with its bonus u;
* the reference's clip of w to [1e-6, 1], whose gradient JAX splits in
  half at either end, mirrored;
* the Function's gradient on CPU tensors is the plain backward's, bit for
  bit; without a gradient the forward's bits do not change; a gradient
  into the final state raises.

A standing departure: where the reference's chunked form overflows
float32 (exp of minus the cumulative log decay within a chunk of 64), its
gradient is not finite; the port's exact recurrence is, and equals the
reference's own exact recurrence (``linear_scan_recurrent``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import scan_ops as jscan_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ops, ref  # noqa: E402

F64_REL = 1e-12
VJP_REL = 2e-5
NAMES = ("dq", "dk", "dv", "dw", "du")


def _inputs(b, h, s, dk, dv, seed, bonus, dtype=np.float64):
    """q, k, v normal at scale 0.5, w = sigmoid(normal + 2.5) (the
    reference kernel test's law), u normal at scale 0.3, dL/do normal."""
    rng = np.random.default_rng(seed)
    q, k = (0.5 * rng.standard_normal((b, h, s, dk)) for _ in range(2))
    v = 0.5 * rng.standard_normal((b, h, s, dv))
    w = 1 / (1 + np.exp(-(rng.standard_normal((b, h, s, dk)) + 2.5)))
    u = 0.3 * rng.standard_normal((h, dk)) if bonus else None
    do = rng.standard_normal((b, h, s, dv))
    return [None if x is None else x.astype(dtype)
            for x in (q, k, v, w, u, do)]


def _leaves(*arrays):
    return [None if a is None else torch.from_numpy(a).requires_grad_(True)
            for a in arrays]


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        name, np.abs(got - want).max(), scale)


def _jax_vjp(fn, primals, cotangent):
    _, pull = jax.vjp(fn, *map(jnp.asarray, primals))
    return [np.asarray(g) for g in pull(jnp.asarray(cotangent))]


# -- the plain backward -------------------------------------------------------

@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("s", [1, 37, 100])
def test_bwd_ref_matches_float64_autograd(s, bonus):
    """Both reads, dk != dv, one chunk (S = 37) and two (S = 100, the
    second ragged), and S = 1 (no decay reaches o: dw is 0)."""
    q, k, v, w, u, do = _inputs(2, 3, s, 5, 7, s, bonus)
    leaves = [x for x in _leaves(q, k, v, w, u) if x is not None]
    o, _ = ref.linear_scan_ref(*leaves[:4], leaves[4] if bonus else None,
                               compute_dtype=torch.float64)
    want = torch.autograd.grad(o, leaves, torch.from_numpy(do),
                               allow_unused=True)
    got = ref.linear_scan_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v, w)),
        None if u is None else torch.from_numpy(u), torch.from_numpy(do),
        compute_dtype=torch.float64)
    for name, g, x, leaf in zip(NAMES, got, want, leaves):
        assert g.dtype == torch.float64
        _close(g, torch.zeros_like(leaf) if x is None else x, F64_REL, name)
    if not bonus:
        assert got[4] is None


def _mamba_views(b, h, s, n, hd, seed):
    """Zamba2's law, drawn with numpy: B and C (B,S,N) normal, dt =
    softplus(0.88 normal) per (b, head, s), the decay exp(-dt), v = x · dt
    (B,H,S,hd)."""
    rng = np.random.default_rng(seed)
    bb, cc = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    dt = np.log1p(np.exp(0.88 * rng.standard_normal((b, h, s))))
    v = (rng.standard_normal((b, h, s, hd)) * dt[..., None])
    do = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    return cc, bb, v.astype(np.float32), np.exp(-dt).astype(np.float32), do


@pytest.mark.parametrize("s", [16, 64, 128])
def test_mamba2_views_gradient_matches_jax_vjp_of_chunked(s):
    """C, B (B,S,N) and the decay (B,H,S) broadcast over the heads and the
    state dim as stride-0 views, as `mamba_block` hands them over; the
    port's autograd sums each view's gradient, the reference's vjp
    transposes its broadcast."""
    b, h, n, hd = 2, 3, 16, 8
    cc, bb, v, a, do = _mamba_views(b, h, s, n, hd, s)

    def jfn(cc, bb, v, a):
        q = jnp.broadcast_to(cc[:, None], (b, h, s, n))
        k = jnp.broadcast_to(bb[:, None], (b, h, s, n))
        w = jnp.broadcast_to(a[..., None], (b, h, s, n))
        return jscan_ops.linear_scan_chunked(q, k, v, w)[0]
    want = _jax_vjp(jfn, (cc, bb, v, a), do)
    tc, tb, tv, ta = _leaves(cc, bb, v, a)
    o, _ = ops.linear_scan(tc[:, None].expand(b, h, s, n),
                           tb[:, None].expand(b, h, s, n), tv,
                           ta[..., None].expand(b, h, s, n))
    got = torch.autograd.grad(o, (tc, tb, tv, ta), torch.from_numpy(do))
    for name, g, x in zip(("dC", "dB", "dv", "da"), got, want):
        assert g.dtype == torch.float32
        _close(g, x, VJP_REL, name)


@pytest.mark.parametrize("s", [16, 64, 128])
def test_rwkv6_gradient_matches_jax_vjp_of_chunked(s):
    """RWKV6's read before the update with the bonus u, a decay per
    channel; every gradient, du included."""
    q, k, v, w, u, do = _inputs(2, 3, s, 16, 8, 100 + s, True, np.float32)
    want = _jax_vjp(lambda *x: jscan_ops.linear_scan_chunked(*x)[0],
                    (q, k, v, w, u), do)
    leaves = _leaves(q, k, v, w, u)
    o, _ = ops.linear_scan(*leaves)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for name, g, x in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        _close(g, x, VJP_REL, name)


# -- the clip of w ------------------------------------------------------------

def test_clip_factor_is_jax_clip_gradient():
    """JAX's gradient of ``log(clip(w, 1e-6, 1))`` at [1, 0.5, 1e-6,
    1e-7] is [0.5, 2, 5e5, 0]: ties at either end split in half."""
    w = np.array([1.0, 0.5, 1e-6, 1e-7, 2.0, 0.0, 0.999], np.float32)
    clip = np.asarray(jax.grad(lambda x: jnp.clip(x, 1e-6, 1.0).sum())(
        jnp.asarray(w)))
    np.testing.assert_array_equal(
        ref._clip_mask(torch.from_numpy(w)).numpy(), clip)
    np.testing.assert_allclose(
        np.asarray(jax.grad(lambda x: jnp.log(jnp.clip(x, 1e-6, 1.0)).sum())(
            jnp.asarray(w[:4]))), [0.5, 2.0, 5e5, 0.0], rtol=1e-6)


def _clipped_recurrence(q, k, v, w, u=None):
    """The reference's exact recurrence on w clipped as its chunked form
    clips it (``jnp.clip(w, 1e-6, 1.0)``, ``scan_ops.py:93``)."""
    return jscan_ops.linear_scan_recurrent(q, k, v, jnp.clip(w, 1e-6, 1.0),
                                           u)[0]


@pytest.mark.parametrize("bonus", [False, True])
def test_clip_ties_match_reference(bonus):
    """w holding exactly 1 (where RWKV6's exp(-exp(x)) rounds to 1) and
    1e-6, and values outside [1e-6, 1]: every gradient is the vjp of the
    reference's clip and exact recurrence, dw 0 outside and at a tie half
    of what torch's clamp (which passes all of it at either end) gives.
    Against the chunked form too, but at w = 1e-6: there its dw divides a
    float32 sum of terms up to 1e6 times larger by w, and lay 0.85 to 0.94
    from the exact value at a largest |dw| of 7.3 to 8.4."""
    q, k, v, w, u, do = _inputs(1, 2, 64, 8, 8, 5 + bonus, bonus,
                                np.float32)
    rng = np.random.default_rng(11)
    pick = rng.random(w.shape)
    w = np.where(pick < 0.15, np.float32(1.0), w)
    w = np.where((pick >= 0.15) & (pick < 0.17), np.float32(1e-6), w)
    w = np.where((pick >= 0.17) & (pick < 0.2), np.float32(1.5), w)
    w = np.where((pick >= 0.2) & (pick < 0.21), np.float32(1e-7), w)
    args = (q, k, v, w) + ((u,) if bonus else ())
    exact = _jax_vjp(_clipped_recurrence, args, do)
    chunked = _jax_vjp(lambda *x: jscan_ops.linear_scan_chunked(*x)[0],
                       args, do)[3]
    got = ops.linear_scan_bwd(*(torch.from_numpy(x) for x in (q, k, v, w)),
                              None if u is None else torch.from_numpy(u),
                              torch.from_numpy(do))
    for name, g, x in zip(NAMES, got, exact):
        _close(g, x, VJP_REL, name)
    dw = got[3].numpy()
    far = w != np.float32(1e-6)
    _close(dw[far], chunked[far], VJP_REL, "dw against the chunked form")
    outside = (w > 1) | (w < 1e-6)
    assert outside.any() and (dw[outside] == 0).all()
    leaves = _leaves(q, k, v, w, u)
    o, _ = ref.linear_scan_ref(*leaves)
    whole = torch.autograd.grad(o, leaves[3], torch.from_numpy(do))[0]
    tie = (w == np.float32(1.0)) | (w == np.float32(1e-6))
    assert tie.any() and (whole.numpy()[tie] != 0).any()
    np.testing.assert_allclose(dw[tie], 0.5 * whole.numpy()[tie],
                               rtol=1e-5, atol=1e-6 * np.abs(dw).max())


# -- the autograd path --------------------------------------------------------

@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("views", [False, True])
def test_function_gradient_on_cpu_is_the_plain_backward_bit_for_bit(
        bonus, views):
    """`linear_scan`'s gradient on CPU tensors is `linear_scan_bwd_ref`'s
    output, the same bits (Mamba2's views: its sums over the broadcast
    axes, as autograd's expand backward takes them)."""
    b, h, s, dk, dv = 2, 3, 70, 6, 5
    q, k, v, w, u, do = _inputs(b, h, s, dk, dv, 21, bonus, np.float32)
    if views:
        q, k, w = q[:, :1], k[:, :1], w[:, :1, :, :1]
        leaves = _leaves(q, k, v, w, u)
        args = [leaves[0].expand(b, h, s, dk), leaves[1].expand(b, h, s, dk),
                leaves[2], leaves[3].expand(b, h, s, dk), leaves[4]]
    else:
        leaves = _leaves(q, k, v, w, u)
        args = leaves
    o, _ = ops.linear_scan(*args)
    live = [x for x in leaves if x is not None]
    got = torch.autograd.grad(o, live, torch.from_numpy(do))
    want = ref.linear_scan_bwd_ref(*(a.detach() for a in args[:4]),
                                   None if u is None else args[4].detach(),
                                   torch.from_numpy(do))
    for name, g, x, leaf in zip(NAMES, got, want, live):
        assert torch.equal(g, x.sum_to_size(leaf.shape)), name


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "requires_grad"])
def test_forward_bits_do_not_change_with_autograd(mode):
    """The Function's forward is the plain version's, bit for bit, with
    autograd off, in inference mode and recording a graph; no launch is
    counted on the CPU."""
    q, k, v, w, u, _ = _inputs(2, 2, 50, 8, 8, 3, True, np.float32)
    arrays = [torch.from_numpy(x) for x in (q, k, v, w, u)]
    want = ref.linear_scan_ref(*arrays)
    before = (ops.launches.count, ops.bwd_launches.count)
    if mode == "requires_grad":
        got = ops.linear_scan(*(x.clone().requires_grad_(True)
                                for x in arrays))
        assert got[0].requires_grad
    else:
        ctx = torch.no_grad() if mode == "no_grad" else \
            torch.inference_mode()
        with ctx:
            got = ops.linear_scan(*arrays)
        assert not got[0].requires_grad
    assert all(torch.equal(g.detach(), x) for g, x in zip(got, want))
    assert (ops.launches.count, ops.bwd_launches.count) == before


@pytest.mark.parametrize("bonus", [False, True])
def test_gradient_into_the_final_state_raises(bonus):
    q, k, v, w, u, _ = _inputs(1, 2, 9, 4, 4, 4, bonus, np.float32)
    leaves = _leaves(q, k, v, w, u)
    o, state = ops.linear_scan(*leaves)
    with pytest.raises(RuntimeError, match="final state"):
        state.sum().backward()
    o, state = ops.linear_scan(*leaves)
    with pytest.raises(RuntimeError, match="final state"):
        (o.sum() + state.sum()).backward()
    o, _ = ops.linear_scan(*leaves)
    o.sum().backward()                     # the state unused: no error
    assert leaves[0].grad is not None


def test_backward_refuses_mixed_devices():
    x = torch.ones(1, 1, 2, 2)
    with pytest.raises(ValueError, match="one cuda device"):
        ops.linear_scan_bwd(x, x, x, x, None, x.to("meta"))


# -- a standing departure -----------------------------------------------------

@pytest.mark.parametrize("bonus", [False, True])
def test_port_gradient_is_finite_where_the_reference_chunked_form_is_not(
        bonus):
    """A standing departure. At w = 0.2, exp(-cumulative log decay)
    passes float32's range within the reference's chunk of 64
    (``scan_ops.py:95``), and its gradient is not finite; the port's
    exact reverse recurrence is finite and equals the vjp of the
    reference's exact recurrence (``linear_scan_recurrent``)."""
    q, k, v, w, u, do = _inputs(1, 2, 64, 8, 8, 17, bonus, np.float32)
    w = np.full_like(w, 0.2)
    args = (q, k, v, w) + ((u,) if bonus else ())
    chunked = _jax_vjp(lambda *x: jscan_ops.linear_scan_chunked(*x)[0],
                       args, do)
    assert not all(np.isfinite(g).all() for g in chunked)
    exact = _jax_vjp(lambda *x: jscan_ops.linear_scan_recurrent(*x)[0],
                     args, do)
    leaves = [x for x in _leaves(q, k, v, w, u) if x is not None]
    o, _ = ops.linear_scan(*leaves[:4], leaves[4] if bonus else None)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for name, g, x in zip(NAMES, got, exact):
        assert torch.isfinite(g).all(), name
        _close(g, x, VJP_REL, name)
