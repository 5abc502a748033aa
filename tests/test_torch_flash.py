"""The port's causal flash attention (its plain version and the autograd op
on the CPU) against the JAX reference's ``flash_attention`` op, run as the
reference's own tests run it: the Pallas kernel in interpret mode, and its
plain oracle. GQA shapes (4 query heads over 2 kv heads), ragged lengths
(not a multiple of the reference's 16-row tiles) and a sliding window;
inputs made with numpy from a seed.

Tolerances, float32: outputs 2e-5 (the reference's own kernel-vs-oracle
tolerance: two softmax orders over up to 40 keys); the log-sum-exp 1e-5
against a float64 numpy oracle; gradients 5e-5 against ``jax.grad`` of the
reference's plain version (each gradient is a sum over up to 40 keys or
queries of float32 products, computed in another order). The op's own
backward is exact to float64 rounding (``gradcheck``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

B, H, KV, D = 2, 4, 2, 32


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    return q, k, v


def _lse_oracle(q, k, window):
    """float64 log-sum-exp of each row's scaled, masked scores (B, H, T)."""
    T = q.shape[1]
    kx = np.repeat(k.astype(np.float64), H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kx) / np.sqrt(D)
    pos = np.arange(T)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["pallas_interpret", "jax_plain"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("T", [37, 64])
def test_forward_matches_reference(T, window, use_kernel):
    q, k, v = _inputs(T, T + window)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window,
                                use_kernel=use_kernel, block_q=16,
                                block_k=16, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o_ref, lse = flash_attention_ref(tq, tk, tv, window=window)
    o_op = flash_attention(tq, tk, tv, window)
    for got in (o_ref, o_op):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _lse_oracle(q, k, window),
                               rtol=1e-5, atol=1e-5)
    o_fwd, lse_fwd = flash_attention_fwd(tq, tk, tv, window)
    assert torch.equal(o_fwd, o_ref) and torch.equal(lse_fwd, lse)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("T", [37, 64])
def test_backward_matches_jax_grad(T, window):
    """The op's gradient against ``jax.grad`` of a scalar of the
    reference's plain version (through its GQA head expansion), with the
    backward's query chunks both wider than T and narrower (16 rows)."""
    q, k, v = _inputs(T, 100 + T + window)
    w = np.random.default_rng(7).standard_normal((B, T, H, D)).astype(
        np.float32)

    def scalar(q, k, v):
        o = jax_flash(q, k, v, window=window, use_kernel=False)
        return jnp.sum(o * jnp.asarray(w))
    want = jax.grad(scalar, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    (flash_attention(tq, tk, tv, window) * torch.from_numpy(w)).sum(
    ).backward()
    o, lse = flash_attention_ref(tq.detach(), tk.detach(), tv.detach(),
                                 window)
    narrow = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o,
                                 lse, torch.from_numpy(w), window, chunk=16)
    for got_op, got_narrow, ref in zip((tq.grad, tk.grad, tv.grad), narrow,
                                       want):
        np.testing.assert_allclose(got_op.numpy(), np.asarray(ref),
                                   rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(got_narrow.numpy(), np.asarray(ref),
                                   rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("window", [0, 3])
def test_backward_gradcheck_float64(window):
    """Finite differences take two forward calls per input element, so the
    inputs are tiny: one sequence of 7, 4 query heads over 2 kv heads of
    width 4."""
    rng = np.random.default_rng(window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_(
        True) for shape in ((1, 7, 4, 4), (1, 7, 2, 4), (1, 7, 2, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, window), (q, k, v))


def test_backward_equals_autograd_through_plain_version():
    """On the CPU the op's hand-written backward and autograd through the
    plain version compute the same function's VJP: equal to float32
    rounding (1e-5)."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(29, 3))
    do = torch.randn((B, 29, H, D), generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(flash_attention_ref(q, k, v, 8)[0], (q, k, v),
                               do)
    got = torch.autograd.grad(flash_attention(q, k, v, 8), (q, k, v), do)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_shape_errors_raise():
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 0))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError):
        flash_attention_fwd(q[:, :, :3], k, v)          # 3 heads over 2
