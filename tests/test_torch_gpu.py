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
another order) and 1e-2 in bfloat16. Flash attention: the output 1e-5 in
float32 and in bfloat16 1e-4 plus 2^-7 of the value (one output rounding
apart, which is at most one bf16 ulp), the float32 log-sum-exp 1e-4
(128- or 256-long dot products and up to 2048-long sums in another
order); its gradients against autograd through the plain version 1e-4
of the largest gradient in float32, and in
bfloat16 2e-2 relative plus 1e-2 of the largest (each side rounds every
gradient to bfloat16 once, and the op's backward takes rowsum(do * o) from
the output already rounded to bfloat16 where autograd keeps it in float32).
The WKV recurrence: float32 outputs and the (always float32) states 2e-5
relative plus 2e-5 of the largest value (sums in another order, a fused
multiply-add in the state update, carried through up to 1000 steps), and
bfloat16 outputs 2^-7 relative plus 1e-3 of the largest (both carry the
state in float32 and round each output once, so they part by at most one
bf16 ulp beyond the float32 drift). The dense flash-decode output as the
paged decode's: 1e-5 in float32 and 1e-2 in bfloat16. The same
tolerances hold the three attention kernels at head width 256 (gemma)
and 64 (musicgen-large's 32 heads, G = 1, and internvl2-1b's G = 7), and
paged_decode at 12 query heads per kv head (mistral-large-123b). Both
split-key decode kernels (at head widths 64, 128 and 256) give the same
output bitwise on repeated calls and in CUDA graph replay and leave their
shared ticket counters at 0. The flash kernel (at 256 and 64) and the
latent kernel are bitwise on repeated calls and in replay too; the latent kernel
also reads q_lat and q_rope as the model's non-contiguous views without a
copy (the call allocates only its output).
The paper's image path, which has no kernel of its own, with TF32 off:
the full-width masked convolutions on the card within 1e-4 of the CPU's;
strict triangular dependence of full-width binary_mnist, and every
sampler's output against ancestral sampling's, bitwise; the masked
convolution leaks no later pixel into an earlier output where cuDNN's
route is measured beside it; the reparametrized noise is drawn on the
logits' device.
The Mamba mixer, which has no kernel of its own, on the reduced jamba cut
in float32 with TF32 off: ``full``, ``window`` and ``advance_state`` on
the card within 1e-4 of the CPU (matmuls summed in another order, carried
through the recurrence), and bitwise self-consistent there; a one-slot
engine equal to the solo sampler on the card bitwise, on the plain route
and on the kernel route.
Preemption and staged adoption on reduced qwen3-1.7b at a fixed W: a
preempted and resumed request equal to the undisturbed engine's, tokens
and verify rounds, bitwise in float32 and bfloat16; a staged drain of
one-token prompts through one slot, every adopted request equal to the
solo sampler bitwise on both routes.
The host cache tier: the arena's buffers page-locked; an upload staged
behind a busy copy counted as overlapped; taken uploads bitwise their
sources; a slab recycled while an upload from it is queued leaves that
upload's bytes intact; a reduced qwen3-1.7b engine that spills and
restages prefix blocks bitwise the tier-less engine.
Crash safety on reduced qwen3-1.7b in bfloat16: the pinned arena entries
of a CUDA engine through the disk tier and back (its layout, two-byte
voids on disk) bitwise, dtype bfloat16 restored; a durable engine bitwise
its volatile run (tokens and verify rounds); a restage through the disk
fall-through bitwise the tier-less engine.
The data-parallel mesh engine with two shards on one card: a cross-shard
migration's landing blocks bitwise the source blocks, under its contract
and sync-debug "error", tokens bitwise the undisturbed run; a data=2
engine at batch 4 bitwise a data=1 engine at batch 2 (the same rows per
call).
The model axis (``tests/torch_tp_driver.py gpu``, two spawned ranks of
reduced qwen3-1.7b in float32): both ranks on this card over gloo give
the same tokens on the kernel path (paged_decode and spec_verify
launched) and window logits within 1e-4 of model 1's; over NCCL, a card a
rank, every checked dispatch also runs under sync-debug "error", which
gloo's host staging rules out (skipped with fewer than two cards).
The model axis for training (``tests/torch_train_mesh_driver.py gpu``,
two spawned ranks of reduced qwen3-1.7b in float32, TF32 off, at data 1 x
model 2): step 1's loss, global norm and named gradients within 1e-4 of the
single-device step on this card (max |difference| over max |value|), every
planted fault past it, two AdamW steps with the same losses on both ranks
within 1e-4 of the single device's, flash on its kernel route (2 x layers
launches a step: the forward and the recompute); over gloo on one card,
and over NCCL a card a rank (skipped with fewer than two cards).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_latent_attention,
                                                     paged_window_write)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_fused_ref, paged_latent_fused_ref, write_window_paged)
from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv
from repro_torch.kernels.rwkv_wkv.ref import rwkv_wkv_ref
from repro_torch.kernels.spec_verify.ops import spec_verify
from repro_torch.kernels.spec_verify.ref import spec_verify_ref

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("R,V", [(16, 151936), (3, 1001), (64, 512),
                                 (16, 151655), (16, 2048)])
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


def _latent_case(cuda, dtype, B, W, lengths, seed, H=128, r=512, dr=64,
                 bs=16, nb=17, empty=()):
    """Inputs of a latent call; q_lat and q_rope are the model's views:
    q_lat a (B, W, H, r) permutation of an (H, B, W, r) tensor, as
    ``MLAttention._absorb_query``'s einsum may give it, and q_rope the
    trailing dr values of (B, W, H, 128 + dr) rows, as ``MLAttention._q``
    slices them. Sequences in ``empty`` have all-zero tables."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = 1 + B * nb + 2
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        dtype)
    ql = rn(H, B, W, r).permute(1, 2, 0, 3)
    qr = rn(B, W, H, 128 + dr)[..., 128:]
    tables = (torch.randperm(P - 1, generator=g, device=cuda)[:B * nb]
              + 1).reshape(B, nb).to(torch.int32)
    for b in empty:
        tables[b] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return (ql, qr, rn(P, bs, r), rn(P, bs, dr), rn(B, W, r), rn(B, W, dr),
            tables, lens, 1.0 / (128 + dr) ** 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,lengths,empty,H,r,dr", [
    (2, 8, (264, 37), (), 128, 512, 64),     # 9 key tiles, to the span
    (1, 64, (16,), (), 128, 512, 64),        # the 64-wide prefill chunk
    (2, 1, (271, 0), (1,), 128, 512, 64),    # the last slot; an empty slot
    (3, 8, (40, 0, 17), (1,), 4, 32, 16)])   # reduced widths, empty slot
def test_paged_latent_kernel_reads_model_views_on_gpu(
        cuda, dtype, B, W, lengths, empty, H, r, dr):
    """q_lat and q_rope as the model's non-contiguous views, read in place:
    the call launches the kernel once and allocates nothing but its
    (B, W, H, r) output (a copy of q or of the output would allocate), it
    writes the pools as the plain version does (block 0 excluded) and its
    output is within the kernel test's tolerance."""
    ql, qr, cp, krp, cn, krn, tables, lens, scale = _latent_case(
        cuda, dtype, B, W, lengths, W + B, H, r, dr, empty=empty)
    assert not ql.is_contiguous() and not qr.is_contiguous()
    c1, k1, c2, k2 = cp.clone(), krp.clone(), cp.clone(), krp.clone()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    reset_launches()
    got, c1, k1 = paged_latent_attention(ql, qr, c1, k1, cn, krn, tables,
                                         lens, scale=scale)
    assert LAUNCHES["paged_latent"] == 1
    out_bytes = -(-got.numel() * got.element_size() // 512) * 512
    assert torch.cuda.max_memory_allocated(cuda) - before == out_bytes
    assert got.shape == (B, W, H, r) and got.is_contiguous()
    want, c2, k2 = paged_latent_fused_ref(ql, qr, c2, k2, cn, krn, tables,
                                          lens, scale=scale)
    assert torch.equal(c1[1:], c2[1:]) and torch.equal(k1[1:], k2[1:])
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    live = [b for b in range(B) if b not in empty]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=tol, atol=tol)


def test_paged_latent_repeats_and_replays_bitwise_on_gpu(cuda):
    """bf16 at the verify shape: two calls in a row, then the call
    captured in a CUDA graph and replayed three times, each give the first
    call's output bitwise and the same pools (the window rows written
    again with the same values)."""
    ql, qr, cp, krp, cn, krn, tables, lens, scale = _latent_case(
        cuda, torch.bfloat16, 2, 8, (100, 37), 11)
    reset_launches()
    first, cp, krp = paged_latent_attention(ql, qr, cp, krp, cn, krn,
                                            tables, lens, scale=scale)
    c_first, k_first = cp.clone(), krp.clone()
    second, cp, krp = paged_latent_attention(ql, qr, cp, krp, cn, krn,
                                             tables, lens, scale=scale)
    assert LAUNCHES["paged_latent"] == 2
    assert torch.equal(first, second)
    assert torch.equal(cp, c_first) and torch.equal(krp, k_first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _, _ = paged_latent_attention(ql, qr, cp, krp, cn, krn,
                                                tables, lens, scale=scale)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert torch.equal(cp, c_first) and torch.equal(krp, k_first)


def _flash_inputs(cuda, B, T, H, KV, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((B, T, H, d), (B, T, KV, d), (B, T, KV, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,window", [
    (2, 512, 16, 8, 0),        # qwen3-1.7b's heads
    (1, 1000, 4, 2, 0),        # a ragged length (not a multiple of 64)
    (1, 777, 16, 8, 512),      # gemma3-1b's sliding window, ragged
    (3, 64, 8, 8, 0),          # one tile, no grouping
    (2, 2048, 16, 8, 0),       # qwen3-1.7b's training shape
    (1, 1, 16, 8, 0),          # one position
    (2, 17, 16, 8, 0),         # shorter than one 128-row tile
    (1, 129, 16, 8, 0),        # one row past a 128-row tile
    (2, 300, 8, 8, 0),         # no grouping, ragged
    (1, 2048, 16, 8, 512)])    # a 512-key window
def test_flash_attention_kernel_matches_plain_on_gpu(cuda, dtype, B, T, H,
                                                     KV, window):
    q, k, v = _flash_inputs(cuda, B, T, H, KV, 128, dtype, T + window)
    reset_launches()
    got, lse = flash_attention_fwd(q, k, v, window)
    assert LAUNCHES["flash_attention"] == 1
    want, lse_want = flash_attention_ref(q, k, v, window)
    torch.cuda.synchronize()
    # both sides compute in float32; bf16 rounds the output once, so the
    # two may part by one bf16 ulp (2^-7 of the value bounds it)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-4)
    torch.testing.assert_close(lse, lse_want, rtol=1e-4, atol=1e-4)
    assert got.dtype == dtype and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,window", [(512, 0), (700, 128)])
def test_flash_attention_backward_matches_autograd_on_gpu(cuda, dtype, T,
                                                          window):
    q, k, v = _flash_inputs(cuda, 1, T, 16, 8, 128, dtype, 3 * T)
    do = torch.randn(q.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(1)
                     ).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    got = torch.autograd.grad(flash_attention(*leaves, window), leaves, do)
    assert LAUNCHES["flash_attention"] == 1
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_leaves, window)[0],
                               ref_leaves, do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        top = float(w.float().abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * top)
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=1e-2 * top)


def test_flash_attention_rejects_what_the_kernel_cannot_take(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 4, 2, 96, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="head width 96"):
        flash_attention_fwd(q, k, v)
    q, k, v = _flash_inputs(cuda, 1, 64, 4, 2, 128, torch.float16, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_fwd(q, k, v)
    q, k, v = _flash_inputs(cuda, 1, 64, 4, 2, 128, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_fwd(q, k.cpu(), v)


def _wkv_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    dtype = got.dtype
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * top)
    else:
        torch.testing.assert_close(got, want, rtol=2.0 ** -7,
                                   atol=1e-3 * top)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,states,with_state", [
    (2, 8, 64, 64, "all", True),        # rwkv6-7b's verify window
    (1, 64, 64, 64, "last", True),      # a 64-token prefill chunk
    (1, 64, 64, 64, "last", False),     # the first chunk, from zero
    (1, 1000, 8, 64, "none", False),    # a ragged zero-state sequence
    (3, 5, 8, 32, "all", True)])        # the reduced config's head width
def test_rwkv_wkv_kernel_matches_plain_on_gpu(cuda, dtype, B, T, H, hd,
                                              states, with_state):
    g = torch.Generator(device=cuda).manual_seed(T + hd + B)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    r, k, v = (rn(B, T, H, hd).to(dtype) for _ in range(3))
    # decays near 1, as the model's exp(-exp(-6 +- ...)) gives
    w = (1 - 0.02 * torch.rand((B, T, H, hd), generator=g,
                               device=cuda)).to(dtype)
    u = rn(H, hd).to(dtype)
    s0 = rn(B, H, hd, hd) if with_state else None
    reset_launches()
    got = rwkv_wkv(r, k, v, w, u, s0, states)
    assert LAUNCHES["rwkv_wkv"] == 1
    want = rwkv_wkv_ref(r, k, v, w, u, s0, states)
    torch.cuda.synchronize()
    if states == "none":
        got, want = (got,), (want,)
    assert got[0].dtype == dtype
    assert all(a.dtype == torch.float32 for a in got[1:])
    for a, b in zip(got, want):
        _wkv_close(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("states", ["none", "all", "last"])
@pytest.mark.parametrize("B,T,H,hd", [
    (2, 1, 64, 64),            # one position
    (1, 17, 64, 64),           # one step past the spread kernel's chunk
    (1, 33, 64, 64),           # one step past the verify kernel's chunk
    (3, 70, 8, 32)])           # the reduced config's head width, B = 3
def test_rwkv_wkv_kernel_edges_on_gpu(cuda, dtype, states, B, T, H, hd):
    """Every form at T = 1, one step past each kernel's chunk (16 steps
    for the zero-state and last-state forms, 32 for every-state) and at
    hd = 32 with B = 3, from a random float32 state where the form takes
    one."""
    g = torch.Generator(device=cuda).manual_seed(T + hd + B)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    r, k, v = (rn(B, T, H, hd).to(dtype) for _ in range(3))
    w = (1 - 0.02 * torch.rand((B, T, H, hd), generator=g,
                               device=cuda)).to(dtype)
    u = rn(H, hd).to(dtype)
    s0 = None if states == "none" else rn(B, H, hd, hd)
    reset_launches()
    got = rwkv_wkv(r, k, v, w, u, s0, states)
    assert LAUNCHES["rwkv_wkv"] == 1
    want = rwkv_wkv_ref(r, k, v, w, u, s0, states)
    torch.cuda.synchronize()
    if states == "none":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        _wkv_close(a, b)


def test_rwkv_full_refuses_a_gradient_on_the_kernel_route(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import RWKV6TimeMix
    cfg = get_config("rwkv6-7b", reduced=True)
    p = RWKV6TimeMix.init(torch.Generator(device=cuda).manual_seed(0), cfg,
                          device=cuda)
    x = torch.randn((1, 16, cfg.d_model), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        RWKV6TimeMix.full(p, x, cfg)
    with torch.no_grad():
        reset_launches()
        y = RWKV6TimeMix.full(p, x, cfg)
        assert LAUNCHES["rwkv_wkv"] == 1
        torch.testing.assert_close(
            y, RWKV6TimeMix.full(p, x, cfg, use_kernel=False), rtol=1e-4,
            atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,S,lengths,H,KV,d,window", [
    (2, 8, 264, (100, 37), 16, 8, 128, 0),    # qwen3-1.7b's solo verify
    (1, 79, 264, (0,), 16, 8, 128, 0),        # its prompt prefill
    (2, 8, 2048, (1500, 700), 16, 8, 128, 512),  # a 512-key window
    (2, 40, 83, (40, 3), 4, 2, 64, 16),       # ragged S, reduced widths
    (2, 8, 2048, (1500, 3), 16, 8, 128, 0),   # 9 splits, short row's empty
    (2, 8, 2048, (1000, 1000), 16, 8, 128, 16),  # one split, no merge
    (1, 1, 2048, (0,), 16, 8, 128, 0),        # every split empty but one
    (1, 255, 264, (0,), 16, 8, 128, 0)])      # the longest prompt prefill
def test_decode_attention_kernel_matches_plain_on_gpu(
        cuda, dtype, B, W, S, lengths, H, KV, d, window):
    g = torch.Generator(device=cuda).manual_seed(W + S)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        dtype)
    q, k, v = rn(B, W, H, d), rn(B, S, KV, d), rn(B, S, KV, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    reset_launches()
    got = decode_attention(q, k, v, lens, window)
    assert LAUNCHES["decode_attention"] == 1
    want = decode_attention_ref(q, k, v, lens, window)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_decode_attention_ticket_counters_reset_on_gpu(cuda):
    """Two calls in a row, then the same call captured in a CUDA graph and
    replayed three times: each gives the first call's output bitwise (the
    merge order is fixed), and the ticket counters are all 0 after. The
    lengths are int64, as the solo sampler passes them."""
    from repro_torch.kernels.split import COUNTER_BUFS
    g = torch.Generator(device=cuda).manual_seed(5)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        torch.bfloat16)
    q, k, v = rn(2, 8, 16, 128), rn(2, 2048, 8, 128), rn(2, 2048, 8, 128)
    lens = torch.tensor([1500, 3], device=cuda)
    reset_launches()
    first = decode_attention(q, k, v, lens)
    second = decode_attention(q, k, v, lens)
    assert LAUNCHES["decode_attention"] == 2
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention(q, k, v, lens)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    assert int(COUNTER_BUFS[q.device].abs().sum()) == 0
    torch.testing.assert_close(first.float(), decode_attention_ref(
        q, k, v, lens).float(), rtol=1e-2, atol=1e-2)


def _paged_case(cuda, dtype, B, W, lengths, seed, H=16, KV=8, d=128, bs=16,
                nb=17):
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = 1 + B * nb + 2
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        dtype)
    tables = (torch.randperm(P - 1, generator=g, device=cuda)[:B * nb]
              + 1).reshape(B, nb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return (rn(B, W, H, d), rn(P, bs, KV, d), rn(P, bs, KV, d),
            rn(B, W, KV, d), rn(B, W, KV, d), tables, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,lengths", [
    (1, 64, (16,)),           # the engine's 64-wide prefill chunk
    (2, 8, (269, 0))])        # past the table's 272 keys; length 0
def test_paged_decode_kernel_shapes_on_gpu(cuda, dtype, B, W, lengths):
    q, kp, vp, kn, vn, tables, lens = _paged_case(cuda, dtype, B, W,
                                                  lengths, W + B)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    reset_launches()
    got, k1, v1 = paged_attention(q, k1, v1, kn, vn, tables, lens)
    assert LAUNCHES["paged_decode"] == 1
    want, k2, v2 = paged_attention_fused_ref(q, k2, v2, kn, vn, tables,
                                             lens)
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_paged_decode_ticket_counters_reset_on_gpu(cuda):
    """Two calls in a row, then the call captured in a CUDA graph and
    replayed three times: each gives the first call's output bitwise and
    the same pools (the window rows are written again, with the same
    values), and the ticket counters, shared with the dense decode kernel,
    are all 0 after."""
    from repro_torch.kernels.split import COUNTER_BUFS
    q, kp, vp, kn, vn, tables, lens = _paged_case(
        cuda, torch.bfloat16, 2, 8, (100, 37), 7)
    reset_launches()
    first, kp, vp = paged_attention(q, kp, vp, kn, vn, tables, lens)
    k_first, v_first = kp.clone(), vp.clone()
    second, kp, vp = paged_attention(q, kp, vp, kn, vn, tables, lens)
    assert LAUNCHES["paged_decode"] == 2
    assert torch.equal(first, second)
    assert torch.equal(kp, k_first) and torch.equal(vp, v_first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _, _ = paged_attention(q, kp, vp, kn, vn, tables, lens)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert torch.equal(kp, k_first) and torch.equal(vp, v_first)
    assert int(COUNTER_BUFS[q.device].abs().sum()) == 0


# ---------------------------------------------------------------------------
# The three attention kernels at gemma's head width 256 (and mistral-large-
# 123b's group of 12 query heads per kv head): window 512 past which the
# lengths run, and none; repeated calls and CUDA-graph replay bitwise.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,window", [
    (2, 2048, 4, 512),         # gemma3-1b's local layers at training length
    (2, 2048, 4, 0),           # its global layers
    (1, 777, 8, 0),            # gemma-2b's 8 heads, ragged
    (1, 777, 4, 512),          # the window, ragged
    (2, 17, 4, 0),             # shorter than one 64-key tile
    (1, 129, 8, 512),          # one row past a 128-row tile
    (1, 1, 4, 0)])             # one position
def test_flash_attention_kernel_at_head_width_256_on_gpu(cuda, dtype, B, T,
                                                         H, window):
    q, k, v = _flash_inputs(cuda, B, T, H, 1, 256, dtype, T + window + H)
    reset_launches()
    got, lse = flash_attention_fwd(q, k, v, window)
    assert LAUNCHES["flash_attention"] == 1
    want, lse_want = flash_attention_ref(q, k, v, window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-4)
    torch.testing.assert_close(lse, lse_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 128])
def test_flash_attention_backward_at_head_width_256_on_gpu(cuda, dtype,
                                                           window):
    q, k, v = _flash_inputs(cuda, 1, 700, 4, 1, 256, dtype, 7 + window)
    do = torch.randn(q.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(2)
                     ).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, window), leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_leaves, window)[0],
                               ref_leaves, do)
    for g, w in zip(got, want):
        top = float(w.float().abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * top)
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=1e-2 * top)


def test_flash_attention_at_head_width_256_repeats_and_replays_on_gpu(cuda):
    """bf16, gemma3-1b's window: a second call and three replays of a
    captured call give the first call's output and lse bitwise."""
    q, k, v = _flash_inputs(cuda, 2, 1000, 4, 1, 256, torch.bfloat16, 9)
    first, lse1 = flash_attention_fwd(q, k, v, 512)
    second, lse2 = flash_attention_fwd(q, k, v, 512)
    assert torch.equal(first, second) and torch.equal(lse1, lse2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, captured_lse = flash_attention_fwd(q, k, v, 512)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert torch.equal(captured_lse, lse1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,S,lengths,H,KV,d,window", [
    (2, 8, 1024, (700, 520), 4, 1, 256, 512),   # gemma3-1b verify, window
    (1, 64, 1024, (600,), 4, 1, 256, 512),      # its 64-wide prefill chunk
    (2, 8, 1024, (700, 300), 4, 1, 256, 0),     # its global layers
    (2, 8, 1024, (700, 3), 8, 1, 256, 0),       # gemma-2b: G = 8
    (1, 1, 2048, (0,), 4, 1, 256, 0),           # every split empty but one
    (2, 8, 1024, (700, 300), 96, 8, 128, 0)])   # mistral-large-123b: G = 12
def test_decode_attention_at_the_dense_configs_shapes_on_gpu(
        cuda, dtype, B, W, S, lengths, H, KV, d, window):
    g = torch.Generator(device=cuda).manual_seed(W + S + d)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        dtype)
    q, k, v = rn(B, W, H, d), rn(B, S, KV, d), rn(B, S, KV, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    reset_launches()
    got = decode_attention(q, k, v, lens, window)
    assert LAUNCHES["decode_attention"] == 1
    want = decode_attention_ref(q, k, v, lens, window)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,lengths,H,KV,d,window,nb", [
    (2, 8, (700, 520), 4, 1, 256, 512, 64),     # gemma3-1b verify, window
    (1, 64, (600,), 4, 1, 256, 512, 64),        # its prefill chunk
    (2, 8, (700, 300), 4, 1, 256, 0, 64),       # its global layers
    (2, 8, (700, 3), 8, 1, 256, 0, 64),         # gemma-2b: G = 8
    (2, 8, (1020, 0), 4, 1, 256, 512, 64),      # past the table's span
    (2, 8, (700, 300), 96, 8, 128, 0, 64)])     # mistral-large-123b: G = 12
def test_paged_decode_at_the_dense_configs_shapes_on_gpu(
        cuda, dtype, B, W, lengths, H, KV, d, window, nb):
    q, kp, vp, kn, vn, tables, lens = _paged_case(
        cuda, dtype, B, W, lengths, W + d + H, H=H, KV=KV, d=d, nb=nb)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    reset_launches()
    got, k1, v1 = paged_attention(q, k1, v1, kn, vn, tables, lens,
                                  window=window)
    assert LAUNCHES["paged_decode"] == 1
    want, k2, v2 = paged_attention_fused_ref(q, k2, v2, kn, vn, tables,
                                             lens, window=window)
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_decode_kernels_at_head_width_256_repeat_and_replay_on_gpu(cuda):
    """bf16, gemma3-1b's verify shape with its window: for each decode
    kernel a second call and three replays of a captured call give the
    first call's output (and pools) bitwise, and the shared ticket
    counters are 0 after."""
    from repro_torch.kernels.split import COUNTER_BUFS
    g = torch.Generator(device=cuda).manual_seed(11)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        torch.bfloat16)
    q, k, v = rn(2, 8, 4, 256), rn(2, 1024, 1, 256), rn(2, 1024, 1, 256)
    lens = torch.tensor([700, 520], device=cuda)
    first = decode_attention(q, k, v, lens, 512)
    assert torch.equal(first, decode_attention(q, k, v, lens, 512))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention(q, k, v, lens, 512)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    q, kp, vp, kn, vn, tables, lens = _paged_case(
        cuda, torch.bfloat16, 2, 8, (700, 520), 12, H=4, KV=1, d=256, nb=64)
    first, kp, vp = paged_attention(q, kp, vp, kn, vn, tables, lens,
                                    window=512)
    k_first, v_first = kp.clone(), vp.clone()
    second, kp, vp = paged_attention(q, kp, vp, kn, vn, tables, lens,
                                     window=512)
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _, _ = paged_attention(q, kp, vp, kn, vn, tables, lens,
                                         window=512)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert torch.equal(kp, k_first) and torch.equal(vp, v_first)
    assert int(COUNTER_BUFS[q.device].abs().sum()) == 0


@pytest.mark.parametrize("W", [1, 8, 64])
@pytest.mark.parametrize("row", [(8, 128), (512,), (64,), (1, 256),
                                 (32, 64), (2, 64)])
def test_paged_write_kernel_bitwise_on_gpu(cuda, W, row):
    """Rows of 2048 (qwen3-1.7b's K/V), 1024 (DeepSeek-V3's c_kv), 128
    bytes (its k_rope), 512 (gemma's one kv head of 256), 4096
    (musicgen-large's 32 kv heads of 64) and 256 (internvl2-1b's 2), bf16,
    with an
    inactive row and with every row active (``active`` None); bitwise on
    every block but the sink 0."""
    g = torch.Generator(device=cuda).manual_seed(W + row[0])
    B, bs, nb = 2, 16, 17
    P = 1 + B * nb + 2
    pool = torch.randn((P, bs) + row, generator=g, device=cuda).to(
        torch.bfloat16)
    new = torch.randn((B, W) + row, generator=g, device=cuda).to(
        torch.bfloat16)
    tables = (torch.randperm(P - 1, generator=g, device=cuda)[:B * nb]
              + 1).reshape(B, nb).to(torch.int32)
    start = torch.tensor([5, nb * bs - W // 2 - 1], dtype=torch.int32,
                         device=cuda)
    for active in (torch.tensor([1, 0], dtype=torch.int32, device=cuda),
                   None):
        p1, p2 = pool.clone(), pool.clone()
        reset_launches()
        paged_window_write(p1, new, tables, start, active)
        assert LAUNCHES["paged_write"] == 1
        write_window_paged(p2, new, tables, start, active)
        assert torch.equal(p1[1:], p2[1:])


# ---------------------------------------------------------------------------
# The frontends' head width 64: flash_attention at musicgen-large's 32 heads
# (G = 1) and internvl2-1b's 14 over 2 (G = 7) at the training length with
# the 256-token prefix (T = 2304), with and without a window; the decode
# kernels at those groups, where a tile holds 8 rows (G = 1) or 56 rows
# make 4 tiles, the last of 8 rows (G = 7).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,window", [
    (2, 2304, 32, 32, 0),      # musicgen-large's training shape
    (2, 2304, 14, 2, 0),       # internvl2-1b's
    (1, 2304, 14, 2, 512),     # a 512-key window
    (1, 777, 32, 32, 128),     # ragged, a window
    (2, 17, 14, 2, 0),         # shorter than one 128-key tile
    (1, 129, 32, 32, 0),       # one row past a 128-row tile
    (1, 1, 14, 2, 0)])         # one position
def test_flash_attention_kernel_at_head_width_64_on_gpu(cuda, dtype, B, T,
                                                        H, KV, window):
    q, k, v = _flash_inputs(cuda, B, T, H, KV, 64, dtype, T + window + H)
    reset_launches()
    got, lse = flash_attention_fwd(q, k, v, window)
    assert LAUNCHES["flash_attention"] == 1
    want, lse_want = flash_attention_ref(q, k, v, window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-4)
    torch.testing.assert_close(lse, lse_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 128])
def test_flash_attention_backward_at_head_width_64_on_gpu(cuda, dtype,
                                                          window):
    q, k, v = _flash_inputs(cuda, 1, 700, 14, 2, 64, dtype, 5 + window)
    do = torch.randn(q.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3)
                     ).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, window), leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_leaves, window)[0],
                               ref_leaves, do)
    for g, w in zip(got, want):
        top = float(w.float().abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * top)
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=1e-2 * top)


def test_flash_attention_at_head_width_64_repeats_and_replays_on_gpu(cuda):
    """bf16, musicgen-large's heads: a second call and three replays of a
    captured call give the first call's output and lse bitwise."""
    q, k, v = _flash_inputs(cuda, 2, 1000, 32, 32, 64, torch.bfloat16, 13)
    first, lse1 = flash_attention_fwd(q, k, v)
    second, lse2 = flash_attention_fwd(q, k, v)
    assert torch.equal(first, second) and torch.equal(lse1, lse2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, captured_lse = flash_attention_fwd(q, k, v)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert torch.equal(captured_lse, lse1)


# (B, W, S, lengths, H, KV): the verify rounds and 64-wide prefill chunks
# of musicgen-large (G = 1) and internvl2-1b (G = 7), served at max_len 1024
FRONTEND_DECODE = [
    (2, 8, 1032, (700, 520), 32, 32),
    (1, 64, 1032, (600,), 32, 32),
    (2, 8, 1032, (700, 300), 14, 2),
    (1, 64, 1032, (600,), 14, 2),
    (2, 8, 1032, (1020, 0), 14, 2)]     # past the span; a length-0 row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,S,lengths,H,KV", FRONTEND_DECODE)
def test_decode_kernels_at_head_width_64_on_gpu(cuda, dtype, B, W, S,
                                                lengths, H, KV):
    g = torch.Generator(device=cuda).manual_seed(W + H + len(lengths))
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        dtype)
    q, k, v = rn(B, W, H, 64), rn(B, S, KV, 64), rn(B, S, KV, 64)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    reset_launches()
    got = decode_attention(q, k, v, lens)
    assert LAUNCHES["decode_attention"] == 1
    torch.testing.assert_close(got.float(), decode_attention_ref(
        q, k, v, lens).float(), rtol=tol, atol=tol)
    q, kp, vp, kn, vn, tables, lens = _paged_case(
        cuda, dtype, B, W, lengths, W + H, H=H, KV=KV, d=64, nb=S // 16)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    got, k1, v1 = paged_attention(q, k1, v1, kn, vn, tables, lens)
    assert LAUNCHES["paged_decode"] == 1
    want, k2, v2 = paged_attention_fused_ref(q, k2, v2, kn, vn, tables,
                                             lens)
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_decode_kernels_at_head_width_64_repeat_and_replay_on_gpu(cuda):
    """bf16, internvl2-1b's verify shape (G = 7): for each decode kernel a
    second call and three replays of a captured call give the first
    call's output (and pools) bitwise; the ticket counters are 0 after."""
    from repro_torch.kernels.split import COUNTER_BUFS
    g = torch.Generator(device=cuda).manual_seed(17)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        torch.bfloat16)
    q, k, v = rn(2, 8, 14, 64), rn(2, 1032, 2, 64), rn(2, 1032, 2, 64)
    lens = torch.tensor([700, 300], device=cuda)
    first = decode_attention(q, k, v, lens)
    assert torch.equal(first, decode_attention(q, k, v, lens))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention(q, k, v, lens)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    q, kp, vp, kn, vn, tables, lens = _paged_case(
        cuda, torch.bfloat16, 2, 8, (700, 300), 19, H=14, KV=2, d=64,
        nb=65)
    first, kp, vp = paged_attention(q, kp, vp, kn, vn, tables, lens)
    k_first, v_first = kp.clone(), vp.clone()
    second, kp, vp = paged_attention(q, kp, vp, kn, vn, tables, lens)
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _, _ = paged_attention(q, kp, vp, kn, vn, tables, lens)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert torch.equal(kp, k_first) and torch.equal(vp, v_first)
    assert int(COUNTER_BUFS[q.device].abs().sum()) == 0


# ---------------------------------------------------------------------------
# The paper's image path. The reference's reaches no Pallas kernel, so the
# port has none of its own there; its exactness on the card rests on the
# masked convolutions' arithmetic, held here with TF32 off: logits at a
# position must not change, to the bit, with the inputs from it on.
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32():
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


def _paper_cfg(name):
    from repro_torch.configs import paper
    kind, arch = name.split(":")
    return (paper.PIXELCNN_FULL if kind == "full"
            else paper.PIXELCNN_REDUCED)[arch]


def _pixelcnn_on(cuda, cfg, T=2, seed=0):
    from repro_torch.configs.paper import forecast_cfg
    from repro_torch.core.forecasting import PixelForecast
    from repro_torch.models.pixelcnn import PixelCNN
    gen = torch.Generator(device=cuda).manual_seed(seed)
    fcfg = forecast_cfg(cfg, T)
    return (PixelCNN.init(gen, cfg, device=cuda),
            PixelForecast.init(gen, fcfg, device=cuda), fcfg)


@pytest.mark.parametrize("name,B", [
    ("full:binary_mnist", 1), ("full:binary_mnist", 16),
    ("full:cifar10_8bit", 16), ("latent", 16)])
def test_pixelcnn_full_width_triangular_bitwise_on_gpu(cuda, no_tf32, name,
                                                       B):
    """cifar10_8bit at B = 16 is the shape where cuDNN's FFT algorithm
    leaked later pixels into earlier logits before the masked
    convolutions ran as one matmul over the input's windows."""
    from repro_torch.configs.paper import LATENT_ARM_FULL
    from repro_torch.models.pixelcnn import PixelCNN
    cfg = LATENT_ARM_FULL if name == "latent" else _paper_cfg(name)
    arm = PixelCNN.make_arm_fn(_pixelcnn_on(cuda, cfg)[0], cfg)
    g = torch.Generator(device=cuda).manual_seed(B)
    K = cfg.categories
    x = torch.randint(0, K, (B, cfg.d), generator=g, device=cuda)
    base, _ = arm(x)
    row = cfg.width * cfg.channels
    for j in sorted({0, 1, row - 1, row, row + 1, cfg.d // 2, cfg.d - 2,
                     cfg.d - 1}):
        one = x.clone()
        one[:, j] = (one[:, j] + 1) % K
        rest = x.clone()
        rest[:, j:] = torch.randint(0, K, (B, cfg.d - j), generator=g,
                                    device=cuda)
        for x2 in (one, rest):
            assert torch.equal(arm(x2)[0][:, :j + 1], base[:, :j + 1]), j


@pytest.mark.parametrize("name", [
    "reduced:binary_mnist", "reduced:svhn_8bit", "reduced:cifar10_5bit",
    "reduced:cifar10_8bit", "full:binary_mnist"])
def test_predictive_sampling_equals_ancestral_bitwise_on_gpu(cuda, no_tf32,
                                                             name):
    from repro_torch.core import predictive_sampling as ps
    from repro_torch.core.forecasting import PixelForecast
    from repro_torch.models.pixelcnn import PixelCNN
    cfg = _paper_cfg(name)
    params, fparams, fcfg = _pixelcnn_on(cuda, cfg)
    arm = PixelCNN.make_arm_fn(params, cfg)
    learned = ps.make_learned_forecast(
        PixelForecast.module_fn(fparams, fcfg),
        window=fcfg.horizon * cfg.channels, group=cfg.channels)
    for B in (1, 4):
        eps = -torch.log(-torch.log(torch.rand(
            (B, cfg.d, cfg.categories), generator=torch.Generator(
                device=cuda).manual_seed(B), device=cuda).clamp_min(1e-30)))
        x_ref, _ = ps.ancestral_sample(arm, eps)
        runs = [ps.fixed_point_sample(arm, eps)] + [
            ps.predictive_sample(arm, fc, eps)
            for fc in (ps.fpi_forecast, ps.zeros_forecast,
                       ps.predict_last_forecast, learned)]
        for x, stats in runs:
            assert x.is_cuda and torch.equal(x, x_ref), name
            assert stats.arm_calls <= cfg.d + 1


@pytest.mark.parametrize("hw,n_in,n_out,k,mask_type", [
    (28, 2, 60, 7, "A"), (28, 120, 60, 3, "B"), (28, 120, 120, 3, "B"),
    (32, 768, 162, 7, "A"), (32, 324, 324, 3, "B"), (8, 512, 160, 7, "A"),
    (32, 162, 162, 3, "T")])
def test_masked_conv2d_on_gpu_matches_cpu(cuda, no_tf32, hw, n_in, n_out, k,
                                          mask_type):
    """The paper's full-width masked convolutions, float32: the card
    against the CPU within 1e-4 absolute (sums of up to 37,632 products of
    unit-scale values in another order)."""
    from repro_torch.nn.core import MaskedConv2D
    groups = 3 if n_in % 3 == 0 and n_out % 3 == 0 else 1
    g = torch.Generator().manual_seed(k + n_in)
    p = MaskedConv2D.init(g, n_in, n_out, (k, k), mask_type=mask_type,
                          groups_in=groups, groups_out=groups, device="cpu")
    p["b"] = torch.randn(n_out, generator=g)
    x = torch.randn((2, hw, hw, n_in), generator=g)
    want = MaskedConv2D.apply(p, x)
    got = MaskedConv2D.apply({k_: v.to(cuda) for k_, v in p.items()},
                             x.to(cuda))
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw,n_in,n_out,k,mask_type,groups", [
    (32, 768, 162, 7, "A", 3), (32, 324, 324, 3, "B", 3),
    (28, 120, 120, 3, "B", 1)])
def test_masked_conv2d_leaks_nothing_beside_cudnn_on_gpu(
        cuda, no_tf32, record_property, hw, n_in, n_out, k, mask_type,
        groups):
    """The port's masked convolution (one matmul over the input's windows)
    beside cuDNN's ``F.conv2d`` of the same masked weights, at B = 16 on
    cifar10_8bit's input layer and a residual one and binary_mnist's
    residual one: the largest change of the outputs at pixels <= p when
    every pixel after p is redrawn. The port's must be 0. cuDNN's is
    recorded (``cudnn_leak`` in the JUnit XML), not asserted: it depends
    on the algorithm cuDNN picks, and it is why ``MaskedConv2D`` does not
    run on cuDNN."""
    from repro_torch.nn.core import MaskedConv2D, _conv
    B = 16
    g = torch.Generator(device=cuda).manual_seed(n_in + n_out)
    p = MaskedConv2D.init(g, n_in, n_out, (k, k), mask_type=mask_type,
                          groups_in=groups, groups_out=groups, device=cuda)
    x = torch.randn((B, hw, hw, n_in), generator=g, device=cuda)
    routes = {"port": lambda t: MaskedConv2D.apply(p, t),
              "cudnn": lambda t: _conv(t, p["w"] * p["_mask"], (1, 1))}
    leaks = {}
    for name, fn in routes.items():
        y = fn(x).reshape(B, hw * hw, n_out)
        leaks[name] = 0.0
        for pix in (0, hw * hw // 2, hw * hw - 2):
            x2 = x.reshape(B, hw * hw, n_in).clone()
            x2[:, pix + 1:] = torch.randn(x2[:, pix + 1:].shape, generator=g,
                                          device=cuda)
            y2 = fn(x2.reshape(x.shape)).reshape(B, hw * hw, n_out)
            leaks[name] = max(leaks[name], float(
                (y2[:, :pix + 1] - y[:, :pix + 1]).abs().max()))
        record_property(f"{name}_leak", leaks[name])
    assert leaks["port"] == 0.0


def test_reparam_noise_is_drawn_on_the_logits_device(cuda, monkeypatch):
    """A key made on the CPU (``prng_key``'s default) draws its noise on
    the card when the logits lie there: threefry runs on the card, and
    nothing is copied over from the host."""
    from repro_torch.core import random as jr
    from repro_torch.core import reparam
    drawn = []
    gumbel = jr.gumbel

    def spy(key, n):
        drawn.append(key[0].device.type)
        return gumbel(key, n)

    monkeypatch.setattr(jr, "gumbel", spy)
    g = torch.Generator(device=cuda).manual_seed(0)
    logits = torch.randn((4, 5, 7), generator=g, device=cuda)
    x = reparam.categorical_sample(jr.prng_key(1), logits)
    eps = reparam.posterior_gumbel(jr.prng_key(2), logits, x)
    assert x.is_cuda and eps.is_cuda and drawn == ["cuda"] * 3
    assert torch.equal(reparam.reparam_argmax(logits, eps), x)


# ---------------------------------------------------------------------------
# the mixture-of-experts layer (torch ops, no kernel of its own)
# ---------------------------------------------------------------------------

def _moe_layer_on(cuda, E, k, score, D=256, F=128, shared=1):
    """An MoE layer of ``E`` experts, top ``k``, bf16, on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE
    cfg = dataclasses.replace(
        get_config("deepseek-v3-671b", reduced=True), d_model=D, moe_d_ff=F,
        n_experts=E, top_k=k, router_score=score, n_shared_experts=shared,
        dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(E + k)
    return cfg, MoE.init(gen, cfg, dtype=torch.bfloat16, device=cuda)


@pytest.mark.parametrize("E,k,score", [(256, 8, "sigmoid"),
                                       (16, 4, "softmax")])
@pytest.mark.parametrize("cf", [None, 1.25, 0.5])
def test_moe_dispatch_matches_a_per_token_loop_on_gpu(cuda, E, k, score, cf):
    """The bf16 dispatch on the card against a plain per-token loop on the
    card: expert ids, each entry's position in its expert's segment and
    the keep mask bitwise. The loop fills its own (E, C, D) buffer token by
    token, runs the same batched expert products on it (at one shape a
    product's row rests on that row alone), and adds each token's kept
    contributions in float32 in ascending expert order, rounded once:
    the output is bitwise the loop's, and a loop that drops one
    contribution (token 0's of the smallest weight) differs. Two calls
    give the same bits."""
    from repro_torch.models.moe import MoE, _glu_hidden, _mlp_apply
    cfg, p = _moe_layer_on(cuda, E, k, score)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 32, cfg.d_model), generator=g, device=cuda).to(
        torch.bfloat16)
    N = 64
    xf = x.reshape(N, -1)
    ids, w, _ = MoE.route(p, xf, cfg)
    C = MoE.capacity(N, cfg, cf)
    order, ids_s, pos, keep = MoE.plan(ids, C)
    ids_h, order_h = ids.cpu(), order.cpu()
    # the loop: tokens in order, each of its experts' next free slot
    fill = [0] * E
    want_pos, want_keep = torch.empty(N * k, dtype=torch.long), torch.empty(
        N * k, dtype=torch.bool)
    where = {}
    for t in range(N):
        for j in range(k):
            e = int(ids_h[t, j])
            where[(t, e)] = fill[e]
            fill[e] += 1
    for i, f in enumerate(order_h.tolist()):
        t, e = f // k, int(ids_h.reshape(-1)[f])
        want_pos[i] = where[(t, e)]
        want_keep[i] = where[(t, e)] < C
    assert torch.equal(ids_s.cpu(), ids_h.reshape(-1)[order_h])
    assert torch.equal(pos.cpu(), want_pos)
    assert torch.equal(keep.cpu(), want_keep)
    if cf is None:
        assert bool(keep.all())
    y, aux = MoE.apply(p, x, cfg, capacity_factor=cf)
    y2, aux2 = MoE.apply(p, x, cfg, capacity_factor=cf)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    pe = p["experts"]
    buf = torch.zeros((E, C, cfg.d_model), dtype=x.dtype, device=cuda)
    for (t, e), c in where.items():
        if c < C:
            buf[e, c] = xf[t]
    out = torch.bmm(_glu_hidden(torch.bmm(buf, pe["up"]),
                                torch.bmm(buf, pe["gate"]), cfg.mlp_kind),
                    pe["down"])
    shared = _mlp_apply(p["shared"], xf, cfg.mlp_kind)

    def loop(drop=None):
        ref = torch.zeros((N, cfg.d_model), device=cuda)
        for t in range(N):
            kept = sorted((int(ids_h[t, j]), j) for j in range(k)
                          if where[(t, int(ids_h[t, j]))] < C)
            if t == 0 and drop:
                kept.remove(min(kept, key=lambda ej: float(w[t, ej[1]])))
            for e, j in kept:
                ref[t] = ref[t] + out[e, where[(t, e)]].float() * w[t, j]
        return ref.to(torch.bfloat16) + shared
    assert torch.equal(y.reshape(N, -1), loop())
    assert not torch.equal(y.reshape(N, -1), loop(drop=True))


@pytest.mark.parametrize("E,k,score", [(256, 8, "sigmoid"),
                                       (16, 4, "softmax")])
def test_moe_no_drop_output_rests_on_its_own_token_on_gpu(cuda, E, k, score):
    """At capacity None and one shape, every other token of the batch and
    window changed: a token's output is bitwise the same. The layer never
    waits for the card (no host sync), at either capacity."""
    from repro_torch.models.moe import MoE
    cfg, p = _moe_layer_on(cuda, E, k, score)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 8, cfg.d_model), generator=g, device=cuda).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = MoE.apply(p, x, cfg, capacity_factor=None)
        MoE.apply(p, x, cfg, capacity_factor=1.25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for b, t in ((0, 0), (1, 5), (0, 7)):
        other = torch.randn(x.shape, generator=g, device=cuda).to(x.dtype)
        other[b, t] = x[b, t]
        y2, _ = MoE.apply(p, other, cfg, capacity_factor=None)
        assert torch.equal(y2[b, t], y[b, t])


def test_moe_top_k_ties_go_to_the_lower_index_on_gpu(cuda):
    """Scores on a coarse grid, so the k boundary falls inside runs of
    exact ties: the lowest indices win, as on the CPU."""
    from repro_torch.models.moe import top_k
    g = torch.Generator(device=cuda).manual_seed(3)
    for E, k in ((256, 8), (16, 4)):
        s = torch.randint(0, 5, (512, E), generator=g, device=cuda).float()
        s[0] = 1.0
        w, ids = top_k(s, k)
        w_cpu, ids_cpu = top_k(s.cpu(), k)
        assert torch.equal(ids.cpu(), ids_cpu)
        assert torch.equal(w.cpu(), w_cpu)
        assert ids[0].tolist() == list(range(k))
        # the lowest index among the tied values at the boundary
        kth = w[:, -1:]
        for r in range(0, 512, 37):
            tied = (s[r] == kth[r]).nonzero().flatten().tolist()
            taken = [i for i in ids[r].tolist() if s[r, i] == kth[r]]
            assert taken == tied[:len(taken)]


# ---------------------------------------------------------------------------
# Mamba and jamba: the reduced jamba cut (4 layers, float32, TF32 off) on
# the card against the same functions on the CPU
# ---------------------------------------------------------------------------

def _jamba_cut():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    return dataclasses.replace(cfg, n_layers=4,
                               layer_block=cfg.layer_block[:4])


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_mamba_on_gpu_matches_cpu(cuda, no_tf32):
    """``full`` at T = 16 and T = 256 (the chunked scan), ``window`` from a
    random state (y, the per-position conv inputs and states) and
    ``advance_state`` at accept counts (1, 5, 8): the card within 1e-4 of
    the CPU (float32 matmuls summed in another order, carried through the
    recurrence). On the card, as on the CPU, the last-state form is the
    last per-position state bitwise and the advanced state the
    per-position one at accept - 1."""
    from repro_torch.models.ssm import Mamba
    from repro_torch.models.transformer import TransformerLM
    cfg = _jamba_cut()
    p = TransformerLM.init(cfg, seed=0, device="cpu")["layers"][0]["mixer"]
    pg = _to(p, cuda)
    g = torch.Generator().manual_seed(1)
    DI = 2 * cfg.d_model

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for B, T in ((2, 16), (1, 256)):
        x = torch.randn((B, T, cfg.d_model), generator=g)
        close(Mamba.full(pg, x.to(cuda), cfg), Mamba.full(p, x, cfg))
    x = torch.randn((3, 8, cfg.d_model), generator=g)
    st = {"conv": torch.randn((3, 3, DI), generator=g),
          "h": 0.3 * torch.randn((3, DI, cfg.ssm_state), generator=g)}
    stg = _to(st, cuda)
    y, per = Mamba.window(p, x, cfg, st)
    yg, perg = Mamba.window(pg, x.to(cuda), cfg, stg)
    close(yg, y)
    for k in ("conv", "h"):
        close(perg[k], per[k])
    y2, last = Mamba.window(pg, x.to(cuda), cfg, stg, last_state_only=True)
    assert torch.equal(y2, yg)
    acc = torch.tensor([1, 5, 8])
    adv = Mamba.advance_state(p, x, cfg, st, acc)
    advg = Mamba.advance_state(pg, x.to(cuda), cfg, stg, acc.to(cuda))
    rows = torch.arange(3, device=cuda)
    for k in ("conv", "h"):
        assert torch.equal(last[k], perg[k][:, -1]), k
        close(advg[k], adv[k])
        assert torch.equal(advg[k], perg[k][rows, acc.to(cuda) - 1]), k


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_jamba_engine_equals_solo_on_gpu(cuda, no_tf32, route):
    """The reduced jamba cut served on the card by a one-slot engine
    (three requests in turn, a 17-token prompt each: one 16-token prefill
    chunk, as the solo sampler's one prefill window; W fixed at 8; a
    64-slot table, the solo cache's length) equals the solo sampler on the
    card bitwise: every pass has the solo run's shapes. ``route`` "plain"
    is the gather fallback against the plain solo sampler, "kernel"
    paged_decode against decode_attention, whose launches are counted."""
    from repro_torch.engine.spec_decode import PredictiveSampler
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    cfg = _jamba_cut()
    params = TransformerLM.init(cfg, seed=0, device=cuda)
    kernel = route == "kernel"
    eng = ServingEngine(cfg, params, batch=1, window_max=8, max_len=56,
                        eps_key=3, block_size=16, adaptive=False,
                        use_verify_kernel=True, use_attention_kernel=kernel,
                        device=cuda)
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=17),
                    new_tokens=12) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    reset_launches()
    done = eng.run()
    served = dict(LAUNCHES)
    assert len(done) == 3 and served["spec_verify"] > 0
    assert (served["paged_decode"] > 0) == kernel
    assert (served["paged_write"] > 0) != kernel
    reset_launches()
    for r in done:
        s = PredictiveSampler(cfg, params, window=8, max_len=56, eps_key=3,
                              device=cuda, use_verify_kernel=True,
                              use_attention_kernel=kernel)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(
            r.result, t[0, :len(r.prompt) + r.new_tokens].cpu().numpy(),
            err_msg=f"request {r.uid}")
    assert (LAUNCHES["decode_attention"] > 0) == kernel


# ---------------------------------------------------------------------------
# Preemption and staged adoption: reduced qwen3-1.7b served on the kernel
# path (paged_decode, spec_verify) with W fixed at 8, TF32 off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preempt_resume_round_trip_on_gpu(cuda, no_tf32, dtype):
    """Three requests through two slots; after the first sync the last
    running slot is preempted (its blocks pulled to the host with one copy
    per dtype, spilled) and later resumed. Every request's tokens and
    verify-round count equal the undisturbed engine's bitwise on the
    card, and both runs launch paged_decode and spec_verify."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(get_config("qwen3-1.7b", reduced=True),
                              dtype=dtype)
    params = TransformerLM.init(cfg, seed=0, device=cuda)

    def run(disturb):
        eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=56,
                            eps_key=3, block_size=16, adaptive=False,
                            use_verify_kernel=True, device=cuda)
        rng = np.random.default_rng(5)
        for i, L in enumerate((17, 23, 9)):
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, L),
                               new_tokens=24))
        reset_launches()
        eng.step()
        if disturb:
            occ = [b for b in range(2) if eng.slots[b] is not None]
            eng.preempt_slot(occ[-1])
        done = {r.uid: r for r in eng.run()}
        assert LAUNCHES["paged_decode"] > 0 and LAUNCHES["spec_verify"] > 0
        return done, eng

    ref, _ = run(False)
    got, eng = run(True)
    assert eng.metrics.preemptions == 1 and eng.metrics.resumes == 1
    assert eng.metrics.blocks_parked >= 1
    for uid, r in got.items():
        assert r.ok
        np.testing.assert_array_equal(r.result, ref[uid].result)
        assert r.calls_used == ref[uid].calls_used
    assert eng.pool.blocks_in_use() == 0


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_staged_drain_equals_solo_on_gpu(cuda, no_tf32, route):
    """Four one-token prompts through one slot and one staging slot at
    k = 8: a row that finishes with a request staged adopts it inside the
    loop (table row, stream and target swapped on the card, no sync), and
    each request equals the solo sampler on the card bitwise (a one-token prompt has no prefill, so
    every pass has the solo run's shapes; a 64-slot table, the solo
    cache's length). ``route`` as in the jamba engine test: "kernel" is
    paged_decode against decode_attention."""
    from repro_torch.configs import get_config
    from repro_torch.engine.spec_decode import PredictiveSampler
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=cuda)
    kernel = route == "kernel"
    eng = ServingEngine(cfg, params, batch=1, window_max=8, max_len=56,
                        eps_key=3, block_size=16, adaptive=False,
                        rounds_per_sync=8, staging_slots=1,
                        adaptive_rounds=False, use_verify_kernel=True,
                        use_attention_kernel=kernel, device=cuda)
    rng = np.random.default_rng(6)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 1),
                           new_tokens=12 + 4 * i))
    reset_launches()
    done = eng.run()
    assert len(done) == 4 and eng.metrics.in_loop_adoptions >= 1
    assert (LAUNCHES["paged_decode"] > 0) == kernel
    assert eng.n.tolist() == [1] and eng.seq_ids.tolist() == [0]
    for r in done:
        s = PredictiveSampler(cfg, params, window=8, max_len=56, eps_key=3,
                              device=cuda, use_verify_kernel=True,
                              use_attention_kernel=kernel)
        t, _ = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                          seq_ids=torch.tensor([r.uid]))
        np.testing.assert_array_equal(
            r.result, t[0, :len(r.prompt) + r.new_tokens].cpu().numpy(),
            err_msg=f"request {r.uid}")


# ---------------------------------------------------------------------------
# the host cache tier: the pinned arena and the staging ring on the card
# ---------------------------------------------------------------------------

def test_host_arena_entries_are_pinned_on_gpu(cuda):
    """With the engine's device a card, every arena buffer and a taken
    park's copy are page-locked, so uploads from them run asynchronously."""
    from repro_torch.serving.hostcache import HostTier
    tier = HostTier(1 << 20, device=cuda)
    src = [torch.randn(64, 32).to(torch.bfloat16), torch.arange(10)]
    assert tier.put_kv(0, 1, src) and tier.put_park(2, src)
    got = tier.get_kv(0, 1)
    assert all(t.is_pinned() for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, src))
    assert all(t.is_pinned() for t in tier.take_park(2))


def test_staging_ring_overlaps_a_busy_copy_on_gpu(cuda):
    """An upload staged while a 128 MB one is still in flight counts as
    overlapped, and the host does not wait for either."""
    from repro_torch.serving.hostcache import StagingRing
    ring = StagingRing(depth=4, device=cuda)
    busy = torch.empty(128 << 20, dtype=torch.uint8, pin_memory=True)
    small = torch.arange(4096, dtype=torch.float32).pin_memory()
    ring.stage("busy", [busy])
    ring.stage("small", [small])
    st = ring.stats_export()
    assert st["h2d_staged"] == 2 and st["h2d_overlapped"] >= 1
    assert ring.take()[0] == "busy"
    tag, devs = ring.take()
    assert tag == "small" and torch.equal(devs[0].cpu(), small)


def test_staged_upload_equals_its_source_bytes_on_gpu(cuda):
    """A staged bf16, float32 and int64 upload, taken after its event,
    equals its host source bit for bit, and is ordered before the current
    stream's later work."""
    from repro_torch.serving.hostcache import StagingRing
    ring = StagingRing(depth=2, device=cuda)
    g = torch.Generator().manual_seed(0)
    src = [torch.randn(17, 8, 128, generator=g).to(torch.bfloat16)
           .pin_memory(),
           torch.randn(3, 5, generator=g).pin_memory(),
           torch.randint(0, 1 << 40, (33,), generator=g).pin_memory()]
    for i in range(3):
        ring.stage(i, src)
    for i in range(3):
        tag, devs = ring.take()
        out = [(d * 1).cpu() for d in devs]     # work on the current stream
        assert tag == i
        for a, b in zip(out, src):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.uint8), b.view(torch.uint8))
    assert ring.take() is None


def test_recycled_slab_leaves_an_upload_in_flight_intact_on_gpu(cuda):
    """An entry's buffer is staged behind a 128 MB upload, then the entry
    is dropped and a put of the same shape recycles that buffer while the
    upload from it is still queued: the arena waits for the upload first,
    so the taken bytes are the old entry's and the new entry holds its
    own."""
    from repro_torch.serving.hostcache import HostTier
    n = 4 << 20                                   # 16 MB of float32
    tier = HostTier(40 << 20, device=cuda)
    old = torch.randn(n, generator=torch.Generator().manual_seed(1))
    assert tier.put_kv(0, 1, [old])
    rows = tier.get_kv(0, 1)
    ring = tier.staging
    ring.stage("busy", [torch.empty(128 << 20, dtype=torch.uint8,
                                    pin_memory=True)])
    ring.stage("old", rows)
    tier.arena.drop(("kv", 0, 1))
    new = torch.full((n,), 7.0)
    assert tier.put_kv(0, 2, [new])
    assert tier.arena.stats.slab_reuses == 1
    assert tier.get_kv(0, 2)[0].data_ptr() == rows[0].data_ptr()
    assert ring.take()[0] == "busy"
    tag, devs = ring.take()
    assert tag == "old" and torch.equal(devs[0].cpu(), old)
    assert torch.equal(tier.get_kv(0, 2)[0], new)


def test_spill_and_restage_equal_the_tierless_engine_on_gpu(cuda, no_tf32):
    """Reduced qwen3-1.7b at batch 1 over a pool B fills: A's prefix
    blocks are spilled into the pinned arena and restaged for C through the
    copy stream; every request equals the tier-less engine's bitwise, which
    prefills C's prefix instead, and both launch paged_decode."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, cfg.vocab, 32)
    prompts = [np.concatenate([prefix, [1]]), rng.integers(0, cfg.vocab, 40),
               np.concatenate([prefix, [2]])]

    def run(mb):
        eng = ServingEngine(cfg, params, batch=1, window_max=8, max_len=56,
                            eps_key=3, block_size=16, num_blocks=5,
                            adaptive=False, use_verify_kernel=True,
                            host_cache_mb=mb, device=cuda)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, new_tokens=8))
        reset_launches()
        done = {r.uid: r.result for r in eng.run()}
        assert LAUNCHES["paged_decode"] > 0 and LAUNCHES["spec_verify"] > 0
        return done, eng.export_metrics()
    tiered, m = run(None)
    plain, mt = run(0)
    assert m["host_staged_blocks"] == 2 and m["h2d_staged"] == 2
    assert mt["blocks_dropped"] >= 2
    assert m["prefill_calls"] < mt["prefill_calls"]
    for u in range(3):
        np.testing.assert_array_equal(tiered[u], plain[u])


# ---------------------------------------------------------------------------
# crash safety: the disk tier under the pinned arena, the durable engine
# ---------------------------------------------------------------------------

def _qwen_bf16(cuda):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(get_config("qwen3-1.7b", reduced=True),
                              dtype="bfloat16")
    return cfg, TransformerLM.init(cfg, seed=0, device=cuda)


def _disk_traffic(cfg):
    from repro_torch.serving.admission import Request
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, cfg.vocab, 32)
    return [Request(uid=0, prompt=np.concatenate([prefix, [1]]),
                    new_tokens=8),
            Request(uid=1, prompt=rng.integers(0, cfg.vocab, 40),
                    new_tokens=8),
            Request(uid=2, prompt=np.concatenate([prefix, [2]]),
                    new_tokens=8)]


def _serve_disk(cfg, params, cuda, reqs, **kw):
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, batch=1, window_max=8, max_len=56,
                        eps_key=3, block_size=16, num_blocks=5,
                        adaptive=False, use_verify_kernel=True, device=cuda,
                        **kw)
    for r in reqs:
        eng.submit(r)
    reset_launches()
    done = {r.uid: r for r in eng.run()}
    assert LAUNCHES["paged_decode"] > 0 and LAUNCHES["spec_verify"] > 0
    return done, eng


def test_bf16_arena_entries_round_trip_the_disk_on_gpu(cuda, no_tf32,
                                                       tmp_path):
    """A CUDA engine's spilled prefix blocks (pinned bfloat16 arena
    entries) go to disk in the reference's layout, bfloat16 as two-byte
    voids, and come back through the tier bitwise, as bfloat16, promoted
    into page-locked memory."""
    from repro_torch.serving.hostcache import decode_entry, durable_name
    cfg, params = _qwen_bf16(cuda)
    _, eng = _serve_disk(cfg, params, cuda, _disk_traffic(cfg),
                         durable_dir=str(tmp_path))
    tier = eng.tier
    kv = [(k, e.tensors) for k, e in tier.arena._entries.items()
          if k[0] == "kv"]
    assert kv and all(t.is_pinned() and t.dtype == torch.bfloat16
                      for _, ts in kv for t in ts)
    entries = [(k, [t.clone() for t in ts]) for k, ts in kv]
    for key, ts in entries:
        assert tier.flush_to_disk(0, [key[-1]]) == 1
        arrays = decode_entry(
            (tmp_path / "disk" / durable_name("kv", 0, key[-1]))
            .read_bytes())
        assert len(arrays) == 2 and all(a.dtype.str == "|V2"
                                        for a in arrays)
        assert tier.arena.drop(key)
        got = tier.get_kv(0, key[-1])
        assert [t.dtype for t in got] == [torch.bfloat16]
        assert torch.equal(got[0].view(torch.int16), ts[0].view(torch.int16))
        again = tier.get_kv(0, key[-1])          # the promoted entry
        assert again[0].is_pinned()
        assert torch.equal(again[0].view(torch.int16),
                           ts[0].view(torch.int16))


def test_durable_engine_equals_its_volatile_run_on_gpu(cuda, no_tf32,
                                                       tmp_path):
    """The journal, the checkpoints and the disk spill change nothing a
    preempting run on the card delivers: tokens and verify rounds bitwise
    the volatile engine's, in bfloat16."""
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    cfg, params = _qwen_bf16(cuda)

    def run(**kw):
        eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=56,
                            eps_key=3, block_size=16, adaptive=False,
                            use_verify_kernel=True, device=cuda, **kw)
        rng = np.random.default_rng(5)
        for i, L in enumerate((17, 23, 9)):
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, L),
                               new_tokens=24))
        reset_launches()
        eng.step()
        occ = [b for b in range(2) if eng.slots[b] is not None]
        eng.preempt_slot(occ[-1])
        done = {r.uid: r for r in eng.run()}
        eng.close()
        assert LAUNCHES["paged_decode"] > 0 and LAUNCHES["spec_verify"] > 0
        return done, eng.export_metrics()
    ref, _ = run()
    got, m = run(durable_dir=str(tmp_path))
    assert m["journal_appends"] > 0 and m["checkpoints_written"] > 0
    for uid, r in got.items():
        np.testing.assert_array_equal(r.result, ref[uid].result)
        assert r.calls_used == ref[uid].calls_used


def test_restage_through_the_disk_equals_the_tierless_engine_on_gpu(
        cuda, no_tf32, tmp_path):
    """An arena of one block over the disk tier: A's two prefix blocks are
    spilled, one goes on to disk, and C restages both (one read back from
    disk and promoted); every request equals the tier-less engine's
    bitwise, which prefills C's prefix instead."""
    cfg, params = _qwen_bf16(cuda)
    block = cfg.n_layers * 2 * 16 * cfg.n_kv_heads * cfg.head_dim * 2
    plain, pe = _serve_disk(cfg, params, cuda, _disk_traffic(cfg),
                            host_cache_mb=0)
    got, eng = _serve_disk(cfg, params, cuda, _disk_traffic(cfg),
                           host_cache_mb=1.5 * block / 2 ** 20,
                           durable_dir=str(tmp_path))
    m, mt = eng.export_metrics(), pe.export_metrics()
    assert m["disk_hits"] >= 1 and m["disk_promotes"] >= 1
    assert got[2].prefix_hit_blocks == 2
    assert m["prefill_calls"] < mt["prefill_calls"]
    for u in range(3):
        np.testing.assert_array_equal(got[u].result, plain[u].result)


# ---------------------------------------------------------------------------
# the hot-path checks on the card: the round loops under sync-debug "error"
# ---------------------------------------------------------------------------

def _serve_checked(cfg, params, cuda, **kw):
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=5, block_size=16, adaptive=False,
                        use_verify_kernel=True, device=cuda, **kw)
    rng = np.random.default_rng(11)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(2, 20))),
            new_tokens=int(rng.integers(8, 24))))
    return {r.uid: (r.result, r.calls_used) for r in eng.run()}, eng


@pytest.mark.parametrize("staging", [0, 2])
def test_round_loops_hold_their_contracts_on_gpu(cuda, no_tf32, monkeypatch,
                                                 staging):
    """With ``REPRO_CHECK_CONTRACTS=1`` every round loop and prefill chunk
    of reduced qwen3-1.7b on the card runs under
    ``set_sync_debug_mode("error")`` (a synchronizing call raises), and the
    first dispatch of each variant passes its contract: the pool's storage
    kept and no pool-shaped tensor made, no host read, at most 8 argument
    signatures a loop, the kernels launched inside the checked region.
    Tokens and verify rounds are bitwise the unchecked run's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=cuda)
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "0")
    off, _ = _serve_checked(cfg, params, cuda, staging_slots=staging)
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "1")
    on, eng = _serve_checked(cfg, params, cuda, staging_slots=staging)
    assert on.keys() == off.keys()
    for uid, (tokens, calls) in off.items():
        np.testing.assert_array_equal(on[uid][0], tokens)
        assert on[uid][1] == calls
    loop = "staged_round" if staging else "round"
    reports = eng.contract_reports
    assert {r.label.split("@")[0] for r in reports} == {loop, "prefill"}
    for r in reports:
        assert r.ok, r
        assert r.metrics["host_callbacks"] == 0
        assert r.metrics["pool_scatters"] == 0
    loops = [r for r in reports if r.label.startswith(loop)]
    assert max(r.metrics["signatures"] for r in loops) <= 8
    for r in loops:
        assert r.metrics["kernel_calls"]["paged_decode"] > 0
        assert r.metrics["kernel_calls"]["spec_verify"] > 0


def test_sync_debug_mode_catches_a_planted_sync_on_gpu(cuda):
    """A scalar read inside the region is a device sync: the card's check
    raises it under sync-debug mode and the contract names it."""
    from repro_torch.analysis import Contract, NoHostCallbacks, check_program
    rep = check_program(lambda x: x * x.sum().item(),
                        (torch.ones(8, device=cuda),),
                        Contract("T", [NoHostCallbacks()]))
    assert not rep.ok
    assert any("sync-debug" in v.summary or "_local_scalar_dense" in
               v.evidence.get("op", "") for v in rep.violations)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("staging", [0, 2])
def test_no_donate_tokens_equal_the_in_place_run_on_gpu(cuda, no_tf32,
                                                        staging):
    """``donate=False`` copies the paged cache out of place at every
    dispatch; tokens and verify rounds bitwise the in-place run's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=cuda)
    inplace, _ = _serve_checked(cfg, params, cuda, staging_slots=staging)
    copied, _ = _serve_checked(cfg, params, cuda, staging_slots=staging,
                               donate=False)
    assert copied.keys() == inplace.keys()
    for uid, (tokens, calls) in inplace.items():
        np.testing.assert_array_equal(copied[uid][0], tokens)
        assert copied[uid][1] == calls


# the data-parallel mesh engine: two shards on one card
# ---------------------------------------------------------------------------

def _two_shards(cuda):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.topology import ServingTopology
    return ServingTopology(make_host_mesh(2, devices=(cuda, cuda)))


def test_migration_copy_between_two_pools_on_gpu(cuda, no_tf32):
    """A live sequence migrated from shard 0 to shard 1 (two pools on one
    card): the landing blocks hold the source blocks' rows bitwise, the
    copy runs under its contract and sync-debug "error", and every
    request's tokens and verify rounds equal the undisturbed run's."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=cuda)

    def run(move):
        eng = ServingEngine(cfg, params, topology=_two_shards(cuda),
                            batch=4, window_max=8, max_len=56, eps_key=3,
                            block_size=16, adaptive=False,
                            use_verify_kernel=True)
        rng = np.random.default_rng(7)
        for i, L in enumerate((17, 23)):
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, L),
                               new_tokens=24))
        eng.step()
        if move:
            src = next(b for b in range(2) if eng.slots[b] is not None)
            dst = next(b for b in range(2, 4) if eng.slots[b] is None)
            pools = [TransformerLM.pool_leaves(cfg, sh.paged)
                     for sh in eng.shards]
            ids = list(eng.owned[src])
            before = [leaf[ids].clone() for leaf in pools[0]]
            eng.migrate_slot(src, dst)
            after = [leaf[list(eng.owned[dst])] for leaf in pools[1]]
            for a, b in zip(before, after):
                assert torch.equal(a, b)
        done = {r.uid: r for r in eng.run()}
        return done, eng

    ref, _ = run(False)
    got, eng = run(True)
    assert eng.metrics.migrations == 1 and eng.metrics.blocks_migrated >= 1
    for uid, r in ref.items():
        np.testing.assert_array_equal(got[uid].result, r.result)
        assert got[uid].calls_used == r.calls_used
    if os.environ.get("REPRO_CHECK_CONTRACTS") == "1":
        assert any(r.contract == "MIGRATION_COPY_CONTRACT" and r.ok
                   for r in eng.contract_reports)
    assert eng.pool.blocks_in_use() == 0


def test_data2_engine_equals_data1_at_half_batch_on_gpu(cuda, no_tf32):
    """At a fixed W a data=2 engine at batch 4 makes every call with the
    rows of a data=1 engine at batch 2 (two per shard), so each row's
    products have the same shapes: tokens and verify rounds bitwise, on
    the kernel path."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device=cuda)

    def run(**kw):
        eng = ServingEngine(cfg, params, window_max=8, max_len=56,
                            eps_key=3, block_size=16, adaptive=False,
                            use_verify_kernel=True, **kw)
        rng = np.random.default_rng(8)
        for i, L in enumerate((17, 23, 9, 30)):
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, L),
                               new_tokens=20))
        reset_launches()
        done = {r.uid: r for r in eng.run()}
        assert LAUNCHES["paged_decode"] > 0 and LAUNCHES["spec_verify"] > 0
        return done

    ref = run(batch=2, device=cuda)
    got = run(batch=4, topology=_two_shards(cuda))
    for uid, r in ref.items():
        np.testing.assert_array_equal(got[uid].result, r.result)
        assert got[uid].calls_used == r.calls_used


@functools.lru_cache(maxsize=None)
def _tp_ranks(backend, **env):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "tests" / "torch_tp_driver.py"), "gpu",
         backend], capture_output=True, text=True, cwd=root, timeout=400,
        env=dict(os.environ, **env))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_tensor_parallel_ranks_agree_on_one_gpu(cuda):
    """Two model ranks on one card over gloo (which stages each collective
    through the host, so the sync check is off there): the same tokens on
    both, through the kernels, and window logits within 1e-4 of model
    1's (float32, row-parallel sums in another order)."""
    r0, r1 = _tp_ranks("gloo")
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["tokens"] == r1["tokens"] and len(r0["tokens"]) == 4
    for r in (r0, r1):
        assert r["launches"]["paged_decode"] > 0
        assert r["launches"]["spec_verify"] > 0
        assert r["logits_err_vs_model1"] < 1e-4
        assert not r["sync_check"]


def test_model_axis_clock_is_rank_0s_on_one_gpu(cuda):
    """The engine's clock on the card at model 2 (gloo): a stepped clock,
    rank 1's running 7x from 1000; rank 0's reading, broadcast as the
    engine is built, at each submit, at each step's top and after its
    host sync, makes every decision on both ranks (the same cut, missed
    deadlines, tokens), and each rank deciding by its own clock is caught
    at the next host sync."""
    r0, r1 = _tp_ranks("gloo")
    assert r0["clock"] == r1["clock"]
    c = r0["clock"]
    assert c["broadcasts"] == {"model": 1 + c["submits"] + c["steps"]
                               + c["metrics"]["host_syncs"]}
    assert c["outcomes"]["0"]["error"] == "timeout"
    assert c["metrics"]["deadline_missed_in_queue"] == 1
    for r in (r0, r1):
        assert r["own_clock"].startswith("RankDivergence"), r["own_clock"]


def test_tensor_parallel_over_nccl_keeps_the_sync_check(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card a rank; this machine has "
                    f"{torch.cuda.device_count()}")
    r0, r1 = _tp_ranks("nccl", REPRO_CHECK_CONTRACTS="1")
    assert r0["backend"] == "nccl" and r0["tokens"] == r1["tokens"]
    for r in (r0, r1):
        assert r["sync_check"] and r["checked"] > 0 and r["contracts_ok"]


def _train_mesh_ranks(backend):
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "tests" / "torch_train_mesh_driver.py"),
         "gpu", backend], capture_output=True, text=True, cwd=root,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _check_train_mesh_ranks(ranks, backend):
    tol = 1e-4
    r0, r1 = ranks
    assert [s["loss"] for s in r0["steps"]] == [s["loss"] for s in r1["steps"]]
    for r in ranks:
        assert r["backend"] == backend
        assert max(r["sound"].values()) < tol, r["sound"]
        for name, f in r["faults"].items():
            assert max(f.values()) > tol, (name, f)
        # reduced qwen's 2 layers, each forward once and again in the
        # backward's recompute
        assert r["grads_flash_launches"] == 4
        assert [s["flash_launches"] for s in r["steps"]] == [4, 4]
        for s, one in zip(r["steps"], r["single"]):
            assert abs(s["loss"] - one["loss"]) < tol
            assert one["flash_launches"] == 4


def test_training_mesh_on_one_gpu_matches_the_single_device_step(cuda):
    _check_train_mesh_ranks(_train_mesh_ranks("gloo"), "gloo")


def test_training_mesh_over_nccl_matches_the_single_device_step(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card a rank; this machine has "
                    f"{torch.cuda.device_count()}")
    _check_train_mesh_ranks(_train_mesh_ranks("nccl"), "nccl")
