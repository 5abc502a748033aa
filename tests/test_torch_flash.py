"""The port's causal flash attention (its plain version and the autograd op
on the CPU) against the JAX reference's ``flash_attention`` op, run as the
reference's own tests run it: the Pallas kernel in interpret mode, and its
plain oracle. GQA shapes (4 query heads over 2 kv heads), ragged lengths
(not a multiple of the reference's 16-row tiles) and a sliding window, at
head width 32 and at gemma's 256; inputs made with numpy from a seed.

Tolerances, float32: outputs 2e-5 (the reference's own kernel-vs-oracle
tolerance: two softmax orders over up to 40 keys); the log-sum-exp 1e-5
against a float64 numpy oracle; gradients 5e-5 against ``jax.grad`` of the
reference's plain version (each gradient is a sum over up to 40 keys or
queries of float32 products, computed in another order). The op's own
backward is exact to float64 rounding (``gradcheck``).

The bf16 CUDA kernel's rounding is emulated here in torch ops (128-key
tiles at head width 128, 64-key tiles at 256) and held within the card
test's tolerance (output 1e-4 + 2^-7 |want|: one bf16
output rounding apart; the float32 log-sum-exp 1e-4) against the plain
version and the reference's plain op; the emulation with P rounded to bf16
alone must break that tolerance.
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
from repro_torch.kernels.flash_attention.ref import (causal_mask,
                                                     flash_attention_ref)

B, H, KV, D = 2, 4, 2, 32

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _inputs(T, seed, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, d)).astype(np.float32)
    return q, k, v


def _lse_oracle(q, k, window):
    """float64 log-sum-exp of each row's scaled, masked scores (B, H, T)."""
    T = q.shape[1]
    kx = np.repeat(k.astype(np.float64), H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kx) / np.sqrt(
        q.shape[-1])
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
@pytest.mark.parametrize("T,d", [pytest.param(37, D, id="37"),
                                 pytest.param(64, D, id="64"),
                                 pytest.param(64, 256, id="64-d256")])
def test_forward_matches_reference(T, d, window, use_kernel):
    q, k, v = _inputs(T, T + window, d)
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
@pytest.mark.parametrize("T,d", [pytest.param(37, D, id="37"),
                                 pytest.param(64, D, id="64"),
                                 pytest.param(64, 256, id="64-d256")])
def test_backward_matches_jax_grad(T, d, window):
    """The op's gradient against ``jax.grad`` of a scalar of the
    reference's plain version (through its GQA head expansion), with the
    backward's query chunks both wider than T and narrower (16 rows)."""
    q, k, v = _inputs(T, 100 + T + window, d)
    w = np.random.default_rng(7).standard_normal((B, T, H, d)).astype(
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


def _tensor_core_flash(q, k, v, window, split_p):
    """The bf16 kernel's arithmetic (csrc/flash_attention.cu, tc::): float32
    scores of the bf16 inputs, an online softmax in float32 over key tiles
    of the kernel's ``Plan<D>::kBN`` (128 keys at d = 128, 64 at 256), P fed to the P V product as bf16 hi = bf16(p) plus lo =
    bf16(p - hi), two products accumulated in float32 (with ``split_p``
    False: P rounded to bf16 alone, as SDPA does), and one bf16 rounding of
    the output. Returns (o (B, T, H, d) bf16, lse (B, H, T) float32)."""
    B, T, H, d = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    s_all = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / d ** 0.5
    pos = torch.arange(T)
    mask = causal_mask(pos, pos, window)
    neg = torch.tensor(-1e30)
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, d))
    bn = 128 if d == 128 else 64
    for k0 in range(0, T, bn):
        mk = mask[:, k0:k0 + bn]
        s = torch.where(mk, s_all[..., k0:k0 + bn], neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mk, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        vt = vf[:, :, k0:k0 + bn]
        hi = p.bfloat16().float()
        pv = hi @ vt + (p - hi).bfloat16().float() @ vt if split_p \
            else hi @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = (acc / l[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)
    return o, m + torch.log(l)


def _beyond(got, want):
    """How many outputs lie beyond the card's bf16 tolerance."""
    err = (got.float() - want.float()).abs()
    return int((err > 1e-4 + 2.0 ** -7 * want.float().abs()).sum())


@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("T,d", [pytest.param(512, 128, id="512"),
                                 pytest.param(1000, 128, id="1000"),
                                 pytest.param(300, 256, id="300-d256")])
def test_tensor_core_rounding_keeps_the_card_tolerance(T, d, window):
    """qwen3-1.7b's head width (128) and gemma's (256), 4 query heads over
    2 kv heads, bf16 inputs from a seed; T = 1000 and 300 leave a ragged
    last tile."""
    rng = np.random.default_rng(T + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, T, h, d)).astype(
        np.float32)).bfloat16() for h in (4, 2, 2))
    o, lse = _tensor_core_flash(q, k, v, window, split_p=True)
    want, lse_want = flash_attention_ref(q, k, v, window)
    jax_want = np.asarray(jax_flash(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), window=window,
        use_kernel=False))
    assert _beyond(o, want) == 0
    assert _beyond(o, torch.from_numpy(jax_want)) == 0
    torch.testing.assert_close(lse, lse_want, rtol=1e-4, atol=1e-4)
    o_bf16_p, _ = _tensor_core_flash(q, k, v, window, split_p=False)
    assert _beyond(o_bf16_p, want) > 0
