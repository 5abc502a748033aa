"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's ops take their plain versions, which are held here
against the JAX kernels run in interpret mode (as tests/kernels runs
them): spec_verify bitwise; the paged writeback bitwise on every pool block
but the sink 0; the fused paged decode and the fused MLA latent decode
with pools bitwise (sink excluded) and outputs within 2e-5 (float32 softmax
sums in another order).

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_write_kernel
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ops import \
    paged_latent_attention as jax_paged_latent
from repro.kernels.spec_verify.kernel import spec_verify_kernel
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_latent_attention,
                                                     paged_window_write)
from repro_torch.kernels.spec_verify.ops import spec_verify


def _t(a):
    return torch.from_numpy(np.array(a))


def _verify_inputs(rng, R, V):
    logits = rng.standard_normal((R, V)).astype(np.float32)
    eps = rng.gumbel(size=(R, V)).astype(np.float32)
    top = (logits + eps).max(axis=1)
    # exact ties: the lowest index must win
    logits[0, 3] = logits[0, V - 2] = top[0] + 1.0
    eps[0, 3] = eps[0, V - 2] = 0.0
    logits[1, :] = -np.inf                 # an all -inf row picks index 0
    return logits, eps


@pytest.mark.parametrize("R,V", [(8, 512), (16, 3000), (3, 1024)])
def test_spec_verify_plain_matches_pallas_bitwise(R, V):
    logits, eps = _verify_inputs(np.random.default_rng(R * V), R, V)
    want = np.asarray(spec_verify_kernel(jnp.asarray(logits),
                                         jnp.asarray(eps), interpret=True))
    got = spec_verify(_t(logits), _t(eps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _tables(rng, B, nb, P, alloc):
    """Distinct physical blocks per row over [1, P); entries past a row's
    ``alloc`` stay 0 (the sink), as for a table not yet grown."""
    ids = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    tables = ids.astype(np.int32)
    for b, a in enumerate(alloc):
        tables[b, a:] = 0
    return tables


@pytest.mark.parametrize("W,active", [(1, [1, 1]), (8, [1, 0]),
                                      (64, [1, 1])])
def test_paged_write_plain_matches_pallas(W, active):
    rng = np.random.default_rng(W)
    B, bs, KV, d, nb = 2, 16, 2, 64, 6
    P = 1 + B * nb
    pool = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    new = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    start = np.array([3, nb * bs - W - 5], np.int32)
    tables = _tables(rng, B, nb, P, [nb, nb - 1])
    act = np.array(active, np.int32)
    want = np.asarray(paged_write_kernel(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(start), jnp.asarray(act), interpret=True))
    got = paged_window_write(_t(pool), _t(new), _t(tables), _t(start),
                             _t(act))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


@pytest.mark.parametrize("W,window", [(1, 0), (8, 0), (64, 0), (8, 24)])
def test_paged_decode_plain_matches_pallas(W, window):
    rng = np.random.default_rng(100 + W + window)
    B, H, KV, d, bs, nb = 2, 4, 2, 64, 16, 6
    P = 1 + B * nb
    q = rng.standard_normal((B, W, H, d)).astype(np.float32)
    kp = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    vp = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    kn = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    vn = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    lengths = np.array([nb * bs - W - 3, 2], np.int32)
    tables = _tables(rng, B, nb, P, [nb, -(-(2 + W) // bs)])
    want, wk, wv = jax_paged(*map(jnp.asarray, (q, kp, vp, kn, vn, tables,
                                                lengths)),
                             window=window, interpret=True)
    got, gk, gv = paged_attention(*map(_t, (q, kp, vp, kn, vn, tables,
                                            lengths)), window=window)
    np.testing.assert_array_equal(gk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_array_equal(gv.numpy()[1:], np.asarray(wv)[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("W", [1, 4, 8])
def test_paged_latent_plain_matches_pallas(W):
    """MLA's absorbed-latent decode at the reduced widths (4 heads, latent
    32, rope 16): one row near the end of its table, one short row whose
    table is not grown past its window."""
    rng = np.random.default_rng(200 + W)
    B, H, r, dr, bs, nb = 2, 4, 32, 16, 4, 6
    P = 1 + B * nb
    ql = rng.standard_normal((B, W, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, W, H, dr)).astype(np.float32)
    cp = rng.standard_normal((P, bs, r)).astype(np.float32)
    kp = rng.standard_normal((P, bs, dr)).astype(np.float32)
    cn = rng.standard_normal((B, W, r)).astype(np.float32)
    kn = rng.standard_normal((B, W, dr)).astype(np.float32)
    lengths = np.array([nb * bs - W - 1, 3], np.int32)
    tables = _tables(rng, B, nb, P, [nb, -(-(3 + W) // bs)])
    scale = 1.0 / 64 ** 0.5                 # 1/sqrt(qk_nope + qk_rope)
    want, wc, wk = jax_paged_latent(
        *map(jnp.asarray, (ql, qr, cp, kp, cn, kn, tables, lengths)),
        scale=scale, interpret=True)
    got, gc, gk = paged_latent_attention(
        *map(_t, (ql, qr, cp, kp, cn, kn, tables, lengths)), scale=scale)
    np.testing.assert_array_equal(gc.numpy()[1:], np.asarray(wc)[1:])
    np.testing.assert_array_equal(gk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
