"""The port's CUDA kernels against their plain versions, on the card.

Each test skips without a CUDA device (decided in a fixture, at run time,
so every worker collects the same tests). This file imports neither JAX
nor the JAX package, so it runs on a GPU machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerances: spec_verify and every writeback bitwise (pools compared on
every block but the sink 0); the paged decode output 1e-5 in float32
(summation order) and 1e-2 in bfloat16 (one output rounding apart); the
latent decode output 2e-5 in float32 (576-long dot products summed in
another order) and 1e-2 in bfloat16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_latent_attention,
                                                     paged_window_write)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_fused_ref, paged_latent_fused_ref, write_window_paged)
from repro_torch.kernels.spec_verify.ops import spec_verify
from repro_torch.kernels.spec_verify.ref import spec_verify_ref

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("R,V", [(16, 151936), (3, 1001), (64, 512)])
def test_spec_verify_kernel_bitwise_on_gpu(cuda, R, V):
    rng = np.random.default_rng(R)
    logits = rng.standard_normal((R, V)).astype(np.float32)
    eps = rng.gumbel(size=(R, V)).astype(np.float32)
    top = (logits + eps).max(axis=1)
    logits[0, 3] = logits[0, V - 2] = top[0] + 1.0     # a tie: lowest wins
    eps[0, 3] = eps[0, V - 2] = 0.0
    logits[1, :] = -np.inf
    lg = torch.from_numpy(logits).to(cuda)
    ep = torch.from_numpy(eps).to(cuda)
    reset_launches()
    got = spec_verify(lg, ep)
    assert LAUNCHES["spec_verify"] == 1
    assert torch.equal(got, spec_verify_ref(lg, ep))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,window,d", [(8, 0, 128), (64, 0, 128),
                                        (8, 24, 64), (1, 0, 64)])
def test_paged_kernels_match_plain_on_gpu(cuda, dtype, W, window, d):
    g = torch.Generator(device=cuda).manual_seed(W + d)
    B, H, KV, bs, nb = 2, 16, 8, 16, 17
    P = 1 + B * nb + 2
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    q, kp, vp = r(B, W, H, d), r(P, bs, KV, d), r(P, bs, KV, d)
    kn, vn = r(B, W, KV, d), r(B, W, KV, d)
    tables = (torch.randperm(P - 1, generator=g, device=cuda)[:B * nb]
              + 1).reshape(B, nb).to(torch.int32)
    lengths = torch.tensor([nb * bs - W - 1, 5], dtype=torch.int32,
                           device=cuda)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    got, k1, v1 = paged_attention(q, k1, v1, kn, vn, tables, lengths,
                                  window=window)
    want, k2, v2 = paged_attention_fused_ref(q, k2, v2, kn, vn, tables,
                                             lengths, window=window)
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    # float32: summation order only; bf16: one output rounding apart
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    act = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    p1, p2 = kp.clone(), kp.clone()
    paged_window_write(p1, kn, tables, lengths, act)
    write_window_paged(p2, kn, tables, lengths, act)
    assert torch.equal(p1[1:], p2[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,H,r,dr", [(8, 128, 512, 64), (64, 128, 512, 64),
                                      (1, 128, 512, 64), (4, 4, 32, 16)])
def test_paged_latent_kernel_matches_plain_on_gpu(cuda, dtype, W, H, r, dr):
    """DeepSeek-V3's full MLA widths (128 heads, latent 512, rope 64) at the
    verify, prefill-chunk and decode widths, and the reduced config's."""
    g = torch.Generator(device=cuda).manual_seed(W + r)
    B, bs, nb = 2, 16, 17
    P = 1 + B * nb + 2
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    ql, qr = rn(B, W, H, r), rn(B, W, H, dr)
    cp, krp = rn(P, bs, r), rn(P, bs, dr)
    cn, krn = rn(B, W, r), rn(B, W, dr)
    tables = (torch.randperm(P - 1, generator=g, device=cuda)[:B * nb]
              + 1).reshape(B, nb).to(torch.int32)
    lengths = torch.tensor([nb * bs - W - 1, 5], dtype=torch.int32,
                           device=cuda)
    scale = 1.0 / (128 + dr) ** 0.5
    c1, k1, c2, k2 = cp.clone(), krp.clone(), cp.clone(), krp.clone()
    reset_launches()
    got, c1, k1 = paged_latent_attention(ql, qr, c1, k1, cn, krn, tables,
                                         lengths, scale=scale)
    assert LAUNCHES["paged_latent"] == 1
    want, c2, k2 = paged_latent_fused_ref(ql, qr, c2, k2, cn, krn, tables,
                                          lengths, scale=scale)
    assert torch.equal(c1[1:], c2[1:]) and torch.equal(k1[1:], k2[1:])
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
