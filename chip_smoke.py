#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``. Phases, each of
which fails the script when it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and hold
   each against its plain PyTorch version on the card at the full-width
   shapes of the serving paths (qwen3-1.7b: 8 kv heads of width 128, 2
   query heads per kv head, 16-slot blocks, bf16 pools, vocab 151,936;
   DeepSeek-V3: 128 heads over one latent of width 512 plus a rope key of
   64 for the latent kernel, the writeback kernel on both latent pools,
   the verify kernel at vocab 129,280), with times of the kernel, the
   plain version and one library call; it also logs ptxas's registers,
   shared memory and spills for the flash, dense-decode, paged-decode,
   paged-write, latent and WKV kernels (``build.log``) and the tensor-core
   (HGMMA, HMMA) instruction count of the flash kernels (``cuobjdump
   -sass``, or "not available");
3. serve 4 requests of qwen3-1.7b through ``ServingEngine`` at full width
   (28 layers, bf16, random weights from a seed) on the kernel path, with
   the launch counts of that run (one paged_decode launch per layer per
   verify round and prefill chunk) and a profile of a shorter one;
4. a shorter qwen run on the gather fallback (``use_attention_kernel=
   False``), which is the path of the writeback kernel;
5. token agreement of phase 3's requests with the port's solo sampler under
   the margin rule;
6. DeepSeek-V3 at its published widths, cut to its three dense-prefix MLA
   layers (phase 13 adds an MoE layer): the same 4 requests served on
   the latent kernel's path with fixed-point forecasts and again with the
   learned forecast (MTP) heads, a profile (with the latent kernel's
   device time and launches), one request on the gather
   fallback (the writeback kernel on both latent pools), and every request
   against the solo sampler under the margin rule;
7. train qwen3-1.7b at full width: 3 steps of ``make_train_step`` (AdamW,
   B = 2, S = 2048, random weights from seed 0) with its attention on the
   flash-attention kernel, the step-1 loss, logits and per-position
   losses against the plain attention path on the same parameters and
   batch (gated beside two planted attention faults the gate must
   catch), the peak memory, and a profile of one step;
8. the paper's forecast-KL objective on DeepSeek-V3 cut as in phase 6: 2
   Adafactor steps at B = 1, S = 512, the trained parameters saved with
   ``save_pytree``, loaded back bitwise, and 1 request served from them
   with the forecast heads;
9. rwkv6-7b at full width (32 layers, bf16, 7.58 B random parameters from
   seed 0): phase 3's 4 requests served with every layer's WKV recurrence
   on the WKV kernel (32 launches per verify pass, all in its verify form,
   and 32 per prefill chunk, all in its prefill form),
   a profile, every request against the solo sampler on the plain scan
   under the margin rule, and ``TransformerLM.apply`` at T = 1024 on the
   kernel route against the plain route, gated beside two planted faults;
10. the solo sampler (``PredictiveSampler``, dense cache) on qwen3-1.7b at
   full width with its attention on the dense flash-decode kernel in the
   prompt prefill and every round (28 launches per pass), its tokens
   against the plain solo sampler and against phase 3's served tokens
   under the margin rule;
11. the samplers of the paper's Table 1 at its full widths, in float32
   with TF32 off, on briefly trained models (their % of ARM calls check
   the path, not the paper's numbers): binary_mnist's PixelCNN (28x28x1,
   K = 2, 60 filters, 2 blocks) with a T = 20 forecast, trained jointly
   (bits/dim + 0.01 x KL, AdamW, batch 32 of synthetic strokes) until
   bits/dim falls, its strict triangular dependence checked bitwise, then
   sampled at batch 1 and 16 by ancestral sampling, the zeros,
   predict-last, fpi and learned forecasts and Algorithm 2, every sample
   bitwise equal to ancestral sampling's, with % ARM calls, seconds per
   batch, ms per ARM call beside its float32 FLOP bound, the busy share
   of a profiled fpi run, and how far the samples rest on their context;
   the same on a control whose samples demonstrably do (the untrained
   ARM, its logits sharpened); then cifar10_8bit's (32x32x3, K = 256, 162
   filters, 5 blocks, T = 5) on synthetic textures, sampled by ancestral,
   fpi and learned forecasts;
12. the samplers of the paper's Table 2 at its full widths: the discrete
   autoencoder (32x32x3, width 512, 8x8x4 latents of K = 128) trained on
   MSE (AdamW 3e-4) until it falls, twice under cuDNN's deterministic
   algorithms, the two bitwise equal; frozen, its latents encoded, and
   the latent PixelCNN (160 filters, 5 blocks, T = 1) trained on them
   and sampled as in phase 11.

13. the mixture-of-experts layer at published widths, each model freed
   before the next: (a) DeepSeek-V3 cut to its 3 dense-prefix layers plus
   1 MoE layer (256 routed experts + 1 shared, top-8, sigmoid; 17.0 B
   parameters), phase 6's 4 requests served on the latent kernel's path
   with fixed-point forecasts and with the forecast heads, profiled, once
   on the gather fallback, every request against the plain solo sampler;
   (b) dbrx-132b cut to 4 (attn, moe) layers (16 experts, top-4, softmax;
   14.3 B), served on paged_decode (dbrx's 6 query heads per kv head) and
   on the gather fallback, held against the solo sampler on
   decode_attention; for each, one MoE call's device ms at the verify and
   prefill shapes beside the byte bound of the expert weights it reads,
   the MoE layers' device ms per pass in the profile, and the distinct
   experts each call's tokens hit. On an MoE model a split past the
   margin is explained only where the served run (its routing recorded by
   position, ``RouteLog``) sent some position up to it to other experts
   than the reference recomputation did, and the reference recomputed
   with the served routing pinned gives the served token or a margin
   below the tolerance. (c) dbrx cut to 2 layers trained 3
   Adafactor steps at B = 2, S = 2048, capacity 1.25, on the flash-
   attention kernel: its logits and per-position losses against the plain
   attention route within ``ROUTE_LIMITS`` with the routing pinned to the
   plain route's (``MoETap``), beside the two planted faults; the unpinned
   routes' differences, ``moe_aux``, the share of token-slots dropped and
   the peak memory;
14. the remaining dense configs at their published widths, each model
   freed before the next: (a) gemma3-1b (26 layers, 22 of them ``local``
   at a 512-key window; one kv head of width 256; vocab 262,144; 1.00 B
   parameters), 4 requests with prompts of 520, 600, 700 and 300 tokens
   (32 new each) in ``ServingEngine(batch=2, window_max=8, block_size=16,
   max_len=1024)`` on paged_decode (26 launches per verify pass and
   prefill chunk, asserted), profiled, one request on the gather fallback
   (paged_write), every request against the solo sampler on
   decode_attention and on the plain route under the margin rule; (b)
   gemma-2b (18 layers, 8 query heads over one kv head of 256, no window;
   2.51 B) the same; (c) mistral-large-123b cut to 8 of its 88 layers (96
   query heads over 8 kv heads of 128, G = 12; 11.9 B) the same; (d)
   gemma3-1b trained 3 AdamW steps at B = 2, S = 2048 on the flash kernel
   (per step 22 windowed and 4 global launches, counted by window), its
   step-1 logits and per-position losses against the plain route within
   ``ROUTE_LIMITS``, which a planted fault that drops the window and one
   that drops the diagonal key tile must break; (e) the kernels at these
   shapes against their plain versions: flash_attention at gemma3-1b's
   training shape (window 512 and none) and gemma-2b's 8 heads,
   decode_attention and paged_decode at gemma3-1b's verify shape and
   64-wide prefill chunk (window 512 over lengths 520-700) and gemma-2b's
   G = 8, paged_decode at mistral's G = 12, paged_write at 512-byte rows,
   spec_verify over vocabularies of 262,144, 256,000 and 32,768;
15. the Mamba mixer: jamba-1.5-large-398b at its published widths cut to
   the first 4 layers of its block ((mamba, dense), (mamba, moe), (mamba,
   dense), (attn, moe): d_model 8192, Mamba d_inner 16384 with 16 states,
   64 query heads over 8 kv heads of 128, 16 experts top-2, vocab 65,536;
   about 23 B parameters, counted and logged), each earlier model freed
   first: (a) phase 14's 4 requests in ``ServingEngine(batch=2,
   window_max=8, block_size=16, max_len=1024)`` on paged_decode (one
   launch per attention layer per verify pass and prefill chunk) and
   spec_verify (one per verify round), asserted, and one request on the
   gather fallback (paged_write); (b) every request against the solo
   sampler on decode_attention and on the plain route under the margin
   rule, a split past the margin judged by the served routing
   (``RouteLog``, ``routing_check``); (c) verify rounds through
   ``make_serve_step`` in one pass and in the two-pass low-memory form
   from the same cache, tokens, accept counts and Mamba states bitwise
   equal; (d) paged_decode at jamba's verify and prefill shapes,
   decode_attention at the solo sampler's and spec_verify over 65,536
   against their plain versions; (e) a profile of a serving run split by
   layer kind (``LayerTap``) and pass kind: device ms and kernel launches
   per verify pass and per prefill chunk of the Mamba layers, the
   attention layer, the MoE layers and the dense FFNs, beside the byte
   bound of the weights they read, the idle share and ms per token. The
   Mamba scan has no kernel of its own (the reference's is XLA ops);
16. the multimodal backbones at head width 64: (c) first, the kernels at
   their shapes against their plain versions (flash_attention at both
   archs' training shapes, T = 2304, in bf16 and float32; paged_decode
   and decode_attention at musicgen-large's G = 1 and internvl2-1b's
   G = 7; paged_write at their 4096- and 256-byte K/V rows; spec_verify
   over vocabularies of 2,048 and 151,655, the odd one on its scalar
   branch); then for each arch at its published widths (bf16, random
   weights from seed 0; musicgen-large 48 layers, 2.42 B parameters,
   internvl2-1b 24 layers, 0.49 B), each freed before the next: (a)
   phase 14's 4 requests in ``ServingEngine(batch=2, window_max=8,
   block_size=16, max_len=1024)`` on paged_decode (one launch per layer
   per verify pass and prefill chunk) and spec_verify (one per verify
   pass), asserted, profiled, every request against the solo sampler on
   decode_attention under the margin rule, one request on the gather
   fallback (paged_write) against the plain solo sampler; (b) 3 AdamW
   steps at B = 2, S = 2048 with a random prefix of 256 embeddings a step
   (``random_prefix``), so T = 2304 positions go through flash_attention
   (one launch per layer per forward, its shape asserted), the token
   positions' logits and losses held against the plain route within
   ``ROUTE_LIMITS`` beside two planted faults, tokens/s, the busy share
   and the peak memory;
17. per-request fault isolation on phase 3's qwen3-1.7b engine and its 4
   requests: a run with an empty ``FaultPlan`` bitwise phase 3's, its ms
   per token beside phase 3's and the device time of the poison select a
   verify round makes while a slot holds a poisoned stream; then, with the window fixed at 8, (a)
   request 1's noise stream poisoned (``FaultPlan(poison_streams=...)``,
   one retry): quarantined as ``nonfinite``, retried on a fresh stream,
   its tokens bitwise a fault-free run on that stream and held against
   the solo sampler there under the margin rule, the other three bitwise
   the fault-free run's; (b) the first block allocation failed
   (``alloc=@0``): one admission fails, is retried, and all four equal
   the fault-free run's; (c) request 0 cancelled after the first host
   sync: the other three equal the fault-free run's. Every run launches
   spec_verify and paged_decode.

Phases 11-12 run no kernel of the port's own: the reference's image path
reaches no Pallas kernel; phase 13's MoE layer neither (the reference's is
XLA ops), but its models run four of the port's kernels at new shapes.

Phase 2 also holds the flash-attention kernel (the training path's) against
its plain version at qwen3-1.7b's training shape, a ragged length and
gemma3-1b's 512-key sliding window, and its backward against autograd
through the plain version; the WKV kernel in its verify, prefill and
zero-state forms at rwkv6-7b's widths; and the dense flash-decode kernel at
qwen3-1.7b's solo verify and prefill shapes and a 512-key sliding window.
The two flash-decode kernels and the flash kernel are also held at
dbrx-132b's 48 query heads over 8 kv heads (G = 6), at the verify shape
and over 2048 positions.

The second line from the end is a JSON object with one entry per kernel
(seven; paged_decode's also carries its 64-wide prefill row, paged_latent's
its prefill and decode rows, rwkv_wkv's its prefill and zero-state rows,
paged_decode's, decode_attention's and flash_attention's their dbrx rows,
with the launches of phase 13's paths, five of them phase 14's rows,
three phase 15's and five phase 16's, with the launches of their paths);
the last line is ``{"ok": true, "device": {...}}``. ``--report PATH``
also writes every number measured to PATH as JSON.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core rate
            "float32": 67e12}      # float32 outside the tensor cores
KV, G, D, BS, V = 8, 2, 128, 16, 151936
G_DBRX = 6                         # dbrx-132b: 48 query heads over 8 kv heads
H_MLA, R_LAT, DR = 128, 512, 64    # DeepSeek-V3's heads, latent, rope key
V_DS = 129280                      # DeepSeek-V3's vocab


def log(*a):
    print(*a, flush=True)


def eager_ms(fn, iters=30, warmup=3):
    """Milliseconds per call of ``fn`` issued eagerly from Python, back to
    back (CUDA events, after a warm-up): the host's issue time included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, reps=5):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events, so the
    host's issue time drops out. Inputs stay where they are (L2-resident
    where they fit, as for a caller that just wrote them)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def times(kernel, plain, library, plain_iters=20):
    """Device and eager milliseconds of a kernel, its plain version and
    the library yardstick (None where no one PyTorch call computes the
    function). ``plain_iters`` cuts the calls captured and issued of a
    plain version that launches thousands of kernels a call."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        if fn is None:
            out[key] = out["eager_" + key] = None
            continue
        if key == "plain_ms" and plain_iters != 20:
            out[key] = device_ms(fn, iters=plain_iters, reps=1)
            out["eager_" + key] = eager_ms(fn, iters=plain_iters, warmup=1)
        else:
            out[key] = device_ms(fn)
            out["eager_" + key] = eager_ms(fn)
    return out


def ptxas_lines(build_log, sources=("flash_attention.cu",
                                     "decode_attention.cu", "paged_decode.cu",
                                     "paged_write.cu", "paged_latent.cu",
                                     "rwkv_wkv.cu")):
    """ptxas's lines for the kernels of ``sources`` in ``build.log``:
    entry functions, registers, shared memory, spills and warnings."""
    keep, current = [], None
    for line in Path(build_log).read_text().splitlines():
        if line.startswith("== "):
            current = line.split()[1]
            continue
        if current in sources and any(
                w in line for w in ("Compiling entry", "registers", "spill",
                                    "arning", "smem")):
            keep.append(f"{current}: {line.strip()}")
    return keep


def sass_counts(lib):
    """HGMMA and HMMA instructions in each flash-attention kernel of the
    built library (``cuobjdump -sass``), or None without ``cuobjdump``."""
    import os
    import re
    import shutil
    tool = shutil.which("cuobjdump") or next(
        (c for c in ("/usr/local/cuda/bin/cuobjdump",) if os.path.exists(c)),
        None)
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if "flash_attention_kernel" in fn:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            continue
        if fn in counts:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def bound(nbytes, nops, dtype):
    t_mem = nbytes / MEM_BYTES_PER_S
    t_ops = nops / PEAK_OPS[dtype]
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_spec_verify(dev, gen, cases=((16, V), (32, V), (16, V_DS))):
    """Rows (R, V): by default B * W at W = 8 and W = 16 over qwen3-1.7b's
    vocab, and W = 8 over DeepSeek-V3's, which splits each row into other
    chunks."""
    import torch
    from repro_torch.kernels.spec_verify.ops import spec_verify
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    rows = {}
    for R, nv in cases:
        name = f"R{R}_V{nv}"
        logits = torch.randn((R, nv), generator=gen, device=dev)
        eps = torch.randn((R, nv), generator=gen, device=dev)
        # exact ties across the split boundaries: the lowest index must win
        top = (logits + eps).max(dim=1).values
        logits[1, 7] = logits[1, nv - 3] = top[1] + 1.0
        eps[1, 7] = eps[1, nv - 3] = 0.0
        logits[2, :] = -float("inf")
        got = spec_verify(logits, eps)
        want = spec_verify_ref(logits, eps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero().flatten().tolist()
            raise AssertionError(f"spec_verify {name} differs at rows {bad}")
        nbytes = 2 * R * nv * 4 + R * 4
        b_ms, b_by = bound(nbytes, 2 * R * nv, "float32")
        rows[name] = {
            "max_abs_err": 0, "bound_ms": b_ms, "bound_by": b_by,
            **times(lambda: spec_verify(logits, eps),
                    lambda: spec_verify_ref(logits, eps),
                    lambda: torch.argmax(logits + eps, -1))}
        log(f"spec_verify R={R} V={nv}: bitwise equal; {rows[name]}")
    return rows


# (name, B, T, window, query heads, kv heads, head width)
FLASH_CASES = (("qwen_train", 2, 2048, 0, 16, KV, D),
               ("ragged", 2, 1000, 0, 16, KV, D),
               ("sliding_window", 2, 2048, 512, 16, KV, D),
               ("dbrx_train", 2, 2048, 0, 48, KV, D))


def check_flash_attention(dev, gen, cases=FLASH_CASES, backward=True):
    """The flash-attention kernel against its plain version (bf16; by
    default qwen3-1.7b's 16 query heads over 8 kv heads of width 128, and
    dbrx-132b's 48 over 8), and with ``backward`` the op's backward against
    autograd through the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rows, worst = {}, {"o": 0.0, "lse": 0.0}
    for name, B, T, window, H, KVH, hd in cases:
        q = torch.randn((B, T, H, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn((B, T, KVH, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((B, T, KVH, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        got, lse = flash_attention_fwd(q, k, v, window)
        want, lse_want = flash_attention_ref(q, k, v, window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        lse_err = (lse - lse_want).abs()
        # both sides compute in float32 (they part by ~1e-6 of the value,
        # summation order) and round the output to bf16 once, so they may
        # differ by one bf16 ulp: 2^-7 |want| is at least one ulp and less
        # than two, plus 1e-4 absolute for values near 0; the float32 lse
        # differs only by summation order (128-long dots, <= 2048-long sums)
        tol = 1e-4 + 2.0 ** -7 * want.float().abs()
        if not bool((err <= tol).all()) or not float(lse_err.max()) <= 1e-4:
            raise AssertionError(
                f"flash_attention {name}: max err o {float(err.max())}, lse "
                f"{float(lse_err.max())} beyond tolerance (o: 1e-4 + "
                "2^-7 |want|; lse: 1e-4)")
        worst["o"] = max(worst["o"], float(err.max()))
        worst["lse"] = max(worst["lse"], float(lse_err.max()))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            pos = torch.arange(T, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - want.float()).abs().max())
        # the least a call must do: each (query, visible key) pair costs a
        # d-long q.k and a d-long p.v (4 * d flops) for every query
        # head; and read q, k, v once, write o and the float32 lse once
        vis = sum(min(i + 1, window) if window else i + 1 for i in range(T))
        nops = 4 * hd * B * H * vis
        nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * 2 \
            + lse.numel() * 4
        b_ms, b_by = bound(nbytes, nops, "bfloat16")
        rows[name] = {
            "B": B, "T": T, "H": H, "KV": KVH, "d": hd, "window": window,
            "max_abs_err": float(err.max()),
            "lse_max_abs_err": float(lse_err.max()),
            "library_max_abs_err": lib_err, "gflop": nops / 1e9,
            "mbytes": nbytes / 1e6, "bound_ms": b_ms, "bound_by": b_by,
            **times(lambda: flash_attention_fwd(q, k, v, window),
                    lambda: flash_attention_ref(q, k, v, window), lib)}
        if name == "qwen_train":
            o_k, lse_k = got, lse
            do = torch.randn(q.shape, generator=gen, device=dev).to(
                torch.bfloat16)
            rows[name]["bwd_eager_ms"] = eager_ms(
                lambda: flash_attention_bwd(q, k, v, o_k, lse_k, do),
                iters=5, warmup=1)
        log(f"flash_attention {name} B={B} T={T} H={H} KV={KVH} d={hd} "
            f"window={window}: {rows[name]}")
    if not backward:
        return rows, worst
    # the backward: the op's hand-written VJP against autograd through the
    # plain version, bf16, B = 1, T = 512
    q, k, v = (torch.randn((1, 512, h, D), generator=gen, device=dev).to(
        torch.bfloat16) for h in (16, KV, KV))
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_leaves)[0],
                               ref_leaves, do)
    torch.cuda.synchronize()
    bwd = {}
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        e = float((g.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        # each side rounds every gradient to bf16 once; the op's backward
        # takes rowsum(do * o) from o already rounded to bf16
        ok = bool(((g.float() - w.float()).abs()
                   <= 1e-2 * top + 2e-2 * w.float().abs()).all())
        bwd[gname] = {"max_abs_err": e, "max_abs": top}
        if not ok:
            raise AssertionError(f"flash_attention backward {gname}: max err "
                                 f"{e} (largest gradient {top}) beyond "
                                 "1e-2 of the largest + 2e-2 relative")
    rows["backward_T512"] = bwd
    log(f"flash_attention backward B=1 T=512 bf16 vs autograd through the "
        f"plain version (tolerance 1e-2 of the largest + 2e-2 relative): "
        f"{bwd}")
    return rows, worst


def _paged_inputs(dev, gen, B, W, nb, lengths, dtype, g=G, kv=KV, d=D):
    import torch
    P = 1 + B * nb + 3
    k_pool = torch.randn((P, BS, kv, d), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((P, BS, kv, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * nb] + 1
    tables = perm.reshape(B, nb).to(torch.int32)
    k_new = torch.randn((B, W, kv, d), generator=gen, device=dev).to(dtype)
    v_new = torch.randn((B, W, kv, d), generator=gen, device=dev).to(dtype)
    q = torch.randn((B, W, kv * g, d), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, k_new, v_new, tables, lens


def _visible_blocks(lengths, W, nb, window):
    total = 0
    for L in lengths:
        hi = min((L + W - 1) // BS, nb - 1)
        lo = max(0, L - window + 1) // BS if window > 0 else 0
        total += hi - lo + 1
    return total


# (name, B, W, lengths, window, G, nb, kv heads, head width); nb 17 =
# (max_len 256 + W 8) / 16; dbrx-132b's group of 6 query heads per kv head
# at the verify shape and over a 2048-token table
PAGED_CASES = (("verify", 2, 8, [100, 37], 0, G, 17, KV, D),
               ("prefill", 1, 64, [16], 0, G, 17, KV, D),
               ("verify_sliding", 2, 8, [200, 61], 32, G, 17, KV, D),
               ("dbrx_verify", 2, 8, [100, 37], 0, G_DBRX, 17, KV, D),
               ("dbrx_S2048", 2, 8, [2030, 1500], 0, G_DBRX, 128, KV, D))


def check_paged_decode(dev, gen, cases=PAGED_CASES):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import (
        gather_view, paged_attention_fused_ref)
    rows, worst = {}, 0.0
    for name, B, W, lengths, window, g, nb, kv, hd in cases:
        ins = _paged_inputs(dev, gen, B, W, nb, lengths, torch.bfloat16, g,
                            kv, hd)
        q, k_pool, v_pool, k_new, v_new, tables, lens = ins
        kp1, vp1 = k_pool.clone(), v_pool.clone()
        kp2, vp2 = k_pool.clone(), v_pool.clone()
        got, kp1, vp1 = paged_attention(q, kp1, vp1, k_new, v_new, tables,
                                        lens, window=window)
        want, kp2, vp2 = paged_attention_fused_ref(
            q, kp2, vp2, k_new, v_new, tables, lens, window=window)
        torch.cuda.synchronize()
        if not (torch.equal(kp1[1:], kp2[1:]) and torch.equal(vp1[1:],
                                                              vp2[1:])):
            raise AssertionError(f"paged_decode {name}: pools differ")
        err = (got.float() - want.float()).abs()
        # both sides compute in float32 and round the output to bf16 once;
        # their sums run in different orders, so a value may round to the
        # neighbouring bf16 number: 2 bf16 ulps of the value, 1e-2 abs floor
        tol = 1e-2 + 2 * 2.0 ** -8 * want.float().abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"paged_decode {name}: max err "
                                 f"{float(err.max())} beyond tolerance")
        worst = max(worst, float(err.max()))
        # library yardstick: SDPA over the gathered, already written view
        kd = gather_view(kp2, tables).transpose(1, 2)      # (B, KV, S, d)
        vd = gather_view(vp2, tables).transpose(1, 2)
        S = kd.shape[2]
        qp = lens.long()[:, None] + torch.arange(W, device=dev)
        kpos = torch.arange(S, device=dev)
        mask = kpos[None, None, :] <= qp[:, :, None]
        if window > 0:
            mask &= kpos[None, None, :] > qp[:, :, None] - window
        mask = mask[:, None]                                # (B, 1, W, S)
        qt = q.transpose(1, 2)                              # (B, H, W, d)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kd, vd, attn_mask=mask, enable_gqa=True)
        # the least a call must move: the cached K and V rows some query
        # sees (positions [first visible, L) of each row; the window slots
        # come from k_new/v_new, not the pool), the W fresh K and V rows read
        # once and written once, q in and out, the table entries it follows
        cached = sum(L - (max(0, L - window + 1) if window else 0)
                     for L in lengths)
        nblk = _visible_blocks(lengths, W, nb, window)
        nbytes = (2 * cached * kv * hd * 2
                  + 2 * q.numel() * 2
                  + 2 * 2 * k_new.numel() * 2
                  + nblk * 4 + B * 4)
        vis = sum(min(L + w + 1, window) if window else L + w + 1
                  for L in lengths for w in range(W))
        b_ms, b_by = bound(nbytes, 4 * g * kv * hd * vis, "bfloat16")
        rows[name] = {
            "B": B, "W": W, "lengths": lengths, "window": window, "G": g,
            "KV": kv, "d": hd, "nb": nb,
            "max_abs_err": float(err.max()), "bound_ms": b_ms,
            "bound_by": b_by,
            **times(lambda: paged_attention(q, kp1, vp1, k_new, v_new,
                                            tables, lens, window=window),
                    lambda: paged_attention_fused_ref(
                        q, kp2, vp2, k_new, v_new, tables, lens,
                        window=window),
                    lib)}
        log(f"paged_decode {name} B={B} W={W} G={g} KV={kv} d={hd} "
            f"lengths={lengths} window={window}: pools bitwise (block 0 "
            "excluded); "
            f"{rows[name]}")
    return rows, worst


_VERIFY, _PREFILL = (2, 8, [100, 37], [1, 1]), (1, 64, [16], [1])
# (name, (B, W, lengths, active), pool row, nb)
WRITE_CASES = (("verify", _VERIFY, (KV, D), 17),
               ("prefill", _PREFILL, (KV, D), 17),
               ("inactive_row", (2, 8, [30, 201], [1, 0]), (KV, D), 17),
               ("latent_c_kv_verify", _VERIFY, (R_LAT,), 17),
               ("latent_c_kv_prefill", _PREFILL, (R_LAT,), 17),
               ("latent_k_rope_verify", _VERIFY, (DR,), 17),
               ("latent_k_rope_prefill", _PREFILL, (DR,), 17))


def check_paged_write(dev, gen, cases=WRITE_CASES):
    """The writeback kernel, bf16, by default on qwen3-1.7b's K/V pool rows
    (8 kv heads of 128) and on DeepSeek-V3's two latent pools (c_kv rows of
    512 and k_rope rows of 64), at the verify and the prefill-chunk
    widths."""
    import torch
    from repro_torch.kernels.paged_attention.ops import paged_window_write
    from repro_torch.kernels.paged_attention.ref import write_window_paged
    rows = {}
    for name, (B, W, lengths, active), row, nb in cases:
        P = 1 + B * nb + 3
        pool = torch.randn((P, BS) + row, generator=gen, device=dev).to(
            torch.bfloat16)
        perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * nb] + 1
        tables = perm.reshape(B, nb).to(torch.int32)
        new = torch.randn((B, W) + row, generator=gen, device=dev).to(
            torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        act = torch.tensor(active, dtype=torch.int32, device=dev)
        p1, p2 = pool.clone(), pool.clone()
        paged_window_write(p1, new, tables, lens, act)
        write_window_paged(p2, new, tables, lens, act)
        torch.cuda.synchronize()
        if not torch.equal(p1[1:], p2[1:]):
            raise AssertionError(f"paged_write {name}: pools differ")
        flat = p2.view((-1,) + row)
        pos = lens.long()[:, None] + torch.arange(W, device=dev)
        phys = torch.gather(tables.long(), 1, (pos // BS).clamp(max=nb - 1))
        idx = (phys * BS + pos % BS).reshape(-1)
        src = new.reshape((-1,) + row)

        def lib():
            flat[idx] = src
        written = sum(a for a in active) * W
        nbytes = (2 * written * math.prod(row) * 2 + tables.numel() * 4
                  + 2 * B * 4)
        b_ms, b_by = bound(nbytes, 0, "bfloat16")
        rows[name] = {
            "max_abs_err": 0, "bound_ms": b_ms, "bound_by": b_by,
            **times(lambda: paged_window_write(p1, new, tables, lens, act),
                    lambda: write_window_paged(p2, new, tables, lens, act),
                    lib)}
        log(f"paged_write {name} B={B} W={W} row {row} ({math.prod(row) * 2} "
            f"B): pools bitwise (block 0 excluded); {rows[name]}")
    return rows


def check_paged_latent(dev, gen):
    """The latent kernel against its plain version at DeepSeek-V3's
    widths (bf16): the verify round (B = 2, W = 8), a 64-wide prefill
    chunk (B = 1, length 16) and a decode step (W = 1), q_lat and q_rope
    passed as the model's non-contiguous views; pools bitwise, the output
    within 1e-2 + 2 bf16 ulps, one kernel a call in the profile. The
    yardstick is SDPA over the gathered view."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.paged_attention.ops import paged_latent_attention
    from repro_torch.kernels.paged_attention.ref import (
        gather_view, paged_latent_fused_ref)
    nb = 17
    scale = 1.0 / math.sqrt(128 + DR)      # 1/sqrt(qk_nope + qk_rope)
    rows, worst = {}, 0.0
    for name, B, W, lengths in (("verify", 2, 8, [100, 37]),
                                ("prefill", 1, 64, [16]),
                                ("decode", 2, 1, [100, 37])):
        P = 1 + B * nb + 3

        def rn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        c_pool, kr_pool = rn(P, BS, R_LAT), rn(P, BS, DR)
        perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * nb] + 1
        tables = perm.reshape(B, nb).to(torch.int32)
        c_new, kr_new = rn(B, W, R_LAT), rn(B, W, DR)
        # the model's views, read in place: q_lat a permutation (as the
        # absorbing einsum may give it), q_rope the rope slice of q's rows
        q_lat = rn(H_MLA, B, W, R_LAT).permute(1, 2, 0, 3)
        q_rope = rn(B, W, H_MLA, 128 + DR)[..., 128:]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        c1, k1 = c_pool.clone(), kr_pool.clone()
        c2, k2 = c_pool.clone(), kr_pool.clone()
        got, c1, k1 = paged_latent_attention(q_lat, q_rope, c1, k1, c_new,
                                             kr_new, tables, lens,
                                             scale=scale)
        want, c2, k2 = paged_latent_fused_ref(q_lat, q_rope, c2, k2, c_new,
                                              kr_new, tables, lens,
                                              scale=scale)
        torch.cuda.synchronize()
        if not (torch.equal(c1[1:], c2[1:]) and torch.equal(k1[1:], k2[1:])):
            raise AssertionError(f"paged_latent {name}: pools differ")
        err = (got.float() - want.float()).abs()
        # both sides compute in float32 and round the output to bf16 once:
        # 2 bf16 ulps of the value, 1e-2 absolute floor
        tol = 1e-2 + 2 * 2.0 ** -8 * want.float().abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"paged_latent {name}: max err "
                                 f"{float(err.max())} beyond tolerance")
        worst = max(worst, float(err.max()))
        # one kernel a call, no copy of q or of the output around it: the
        # call allocates only its output, and the profile shows one kernel
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            paged_latent_attention(q_lat, q_rope, c1, k1, c_new, kr_new,
                                   tables, lens, scale=scale)
            torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        kern = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if extra != got.numel() * 2 or (
                kern and (len(kern) != 1 or "paged_latent_" not in kern[0])):
            raise AssertionError(f"paged_latent {name}: a call allocated "
                                 f"{extra} B and ran {kern}")
        # library yardstick: SDPA over the gathered, already written view,
        # q = [q_lat, q_rope], k = [c_kv, k_rope], v = c_kv, one kv head
        c = gather_view(c2, tables)                          # (B, S, r)
        S = c.shape[1]
        kcat = torch.cat([c, gather_view(k2, tables)], -1)[:, None]
        qcat = torch.cat([q_lat, q_rope], -1).transpose(1, 2)
        qp = lens.long()[:, None] + torch.arange(W, device=dev)
        mask = (torch.arange(S, device=dev)[None, None, :]
                <= qp[:, :, None])[:, None]                  # (B, 1, W, S)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qcat, kcat, c[:, None], attn_mask=mask, scale=scale,
            enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - want.float()).abs().max())
        # the least a call must move: the cached latent rows [0, L) of
        # each sequence read once (the window slots come from the fresh
        # rows), the fresh rows read once and written once, the queries in,
        # the output out, the table entries it follows
        nblk = _visible_blocks(lengths, W, nb, 0)
        nbytes = (sum(lengths) * (R_LAT + DR) * 2
                  + (q_lat.numel() + q_rope.numel() + got.numel()) * 2
                  + 2 * (c_new.numel() + kr_new.numel()) * 2
                  + nblk * 4 + B * 4)
        vis = sum(L + w + 1 for L in lengths for w in range(W))
        nops = H_MLA * vis * (2 * (R_LAT + DR) + 2 * R_LAT)
        b_ms, b_by = bound(nbytes, nops, "bfloat16")
        rows[name] = {
            "max_abs_err": float(err.max()), "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_by": b_by, "kernels_per_call": kern,
            **times(lambda: paged_latent_attention(
                        q_lat, q_rope, c1, k1, c_new, kr_new, tables, lens,
                        scale=scale),
                    lambda: paged_latent_fused_ref(
                        q_lat, q_rope, c2, k2, c_new, kr_new, tables, lens,
                        scale=scale),
                    lib)}
        log(f"paged_latent {name} B={B} W={W} H={H_MLA} r={R_LAT} dr={DR} "
            f"lengths={lengths}: pools bitwise (block 0 excluded); "
            f"{rows[name]}")
    return rows, worst


H_RWKV, HD_RWKV = 64, 64            # rwkv6-7b's heads and head width


def wkv_close(got, want):
    """(max abs error, within tolerance): float32 outputs and states 2e-5
    relative plus 2e-5 of the largest value (sums in another order, a fused
    multiply-add in the state update); bf16 outputs 2^-7 relative plus 1e-3
    of the largest (both carry the state in float32 and round each output
    once)."""
    import torch
    err = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    rel, floor = ((2e-5, 2e-5) if got.dtype == torch.float32
                  else (2.0 ** -7, 1e-3))
    ok = bool((err <= rel * want.float().abs() + floor * top).all())
    return float(err.max()), ok


def check_rwkv_wkv(dev, gen):
    """The WKV kernel against its plain version at rwkv6-7b's widths (64
    heads of 64): the verify window's form from a random float32 state
    (B = 2, W = 8, bf16 and float32 inputs), the prefill form (state after
    the last of a 64-token chunk), and the zero-state form at T = 1024 and
    a ragged T = 1000. No single PyTorch call computes the recurrence, so
    there is no library time."""
    import torch
    from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv
    from repro_torch.kernels.rwkv_wkv.ref import rwkv_wkv_ref
    H, hd = H_RWKV, HD_RWKV
    rows, worst = {}, 0.0
    for name, B, T, states, dtype in (
            ("verify", 2, 8, "all", "bfloat16"),
            ("verify_f32", 2, 8, "all", "float32"),
            ("prefill", 1, 64, "last", "bfloat16"),
            ("zero_state_T1024", 1, 1024, "none", "bfloat16"),
            ("ragged_T1000", 1, 1000, "none", "bfloat16")):
        dt = getattr(torch, dtype)

        def rn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        r, k, v = rn(B, T, H, hd), rn(B, T, H, hd), rn(B, T, H, hd)
        # decays near 1, as the model's exp(-exp(-6 +- ...)) gives
        w = (1 - 0.02 * torch.rand((B, T, H, hd), generator=gen,
                                   device=dev)).to(dt)
        u = rn(H, hd)
        s0 = (0.3 * torch.randn((B, H, hd, hd), generator=gen, device=dev)
              if states != "none" else None)
        got = rwkv_wkv(r, k, v, w, u, s0, states)
        want = rwkv_wkv_ref(r, k, v, w, u, s0, states)
        torch.cuda.synchronize()
        if states == "none":
            got, want = (got,), (want,)
        errs = [wkv_close(a, b) for a, b in zip(got, want)]
        if not all(ok for _, ok in errs):
            raise AssertionError(f"rwkv_wkv {name}: max errors "
                                 f"{[e for e, _ in errs]} beyond tolerance")
        err = max(e for e, _ in errs)
        worst = max(worst, err)
        size = torch.finfo(dt).bits // 8
        # the least a call must move: r, k, v, w and u read once, the
        # float32 initial state read once, y written once and the float32
        # states returned written once; per step and head it does 7 hd^2
        # operations (the k^T v outer product, u * and S + it, r times it,
        # w * S + k^T v)
        n_out = {"all": B * T, "last": B, "none": 0}[states]
        nbytes = ((5 * r.numel() + u.numel()) * size
                  + (0 if s0 is None else s0.numel() * 4)
                  + n_out * H * hd * hd * 4)
        b_ms, b_by = bound(nbytes, 7 * B * T * H * hd * hd, dtype)
        rows[name] = {
            "B": B, "T": T, "states": states, "dtype": dtype,
            "max_abs_err": err, "mbytes": nbytes / 1e6, "bound_ms": b_ms,
            "bound_by": b_by,
            **times(lambda: rwkv_wkv(r, k, v, w, u, s0, states),
                    lambda: rwkv_wkv_ref(r, k, v, w, u, s0, states), None,
                    plain_iters=20 if T <= 64 else 2)}
        log(f"rwkv_wkv {name} B={B} T={T} H={H} hd={hd} states={states} "
            f"{dtype}: {rows[name]}")
    return rows, worst


# (name, B, W, S, lengths, window, G, kv heads, head width)
DECODE_CASES = (("verify", 2, 8, 264, [100, 37], 0, G, KV, D),
                ("prefill", 1, 79, 264, [0], 0, G, KV, D),
                ("sliding_window", 2, 8, 2048, [1500, 700], 512, G, KV, D),
                ("dbrx_verify", 2, 8, 264, [100, 37], 0, G_DBRX, KV, D),
                ("dbrx_S2048", 2, 8, 2048, [2030, 1500], 0, G_DBRX, KV, D))


def check_decode_attention(dev, gen, cases=DECODE_CASES):
    """The dense flash-decode kernel against its plain version at
    qwen3-1.7b's widths (16 query heads over 8 kv heads of 128, bf16): the
    solo sampler's verify round (B = 2, W = 8 over a 264-slot cache,
    lengths 100 and 37), its prompt prefill (W = 79 from length 0) and a
    512-key sliding window at S = 2048; and at dbrx-132b's 48 query heads
    over 8 (G = 6), its verify round and a 2048-slot cache; the yardstick
    is SDPA with a boolean mask and ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rows, worst = {}, 0.0
    for name, B, W, S, lengths, window, g, kv, hd in cases:
        H = kv * g
        def rn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, k, v = rn(B, W, H, hd), rn(B, S, kv, hd), rn(B, S, kv, hd)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, lens, window)
        want = decode_attention_ref(q, k, v, lens, window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        # both sides compute in float32 and round the output to bf16 once:
        # 2 bf16 ulps of the value, 1e-2 absolute floor (as paged_decode)
        tol = 1e-2 + 2 * 2.0 ** -8 * want.float().abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"decode_attention {name}: max err "
                                 f"{float(err.max())} beyond tolerance")
        worst = max(worst, float(err.max()))
        qp = lens.long()[:, None] + torch.arange(W, device=dev)
        kpos = torch.arange(S, device=dev)
        mask = kpos[None, None, :] <= qp[:, :, None]
        if window > 0:
            mask &= kpos[None, None, :] > qp[:, :, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - want.float()).abs().max())
        # the least a call must move: the K and V rows some query sees,
        # q in and out, the lengths
        seen = 0
        for L in lengths:
            lo = max(0, L - window + 1) if window else 0
            seen += min(L + W - 1, S - 1) - lo + 1
        nbytes = 2 * seen * kv * hd * 2 + 2 * q.numel() * 2 + B * 4
        vis = sum(min(L + w + 1, window) if window else L + w + 1
                  for L in lengths for w in range(W))
        b_ms, b_by = bound(nbytes, 4 * H * hd * vis, "bfloat16")
        rows[name] = {
            "B": B, "W": W, "S": S, "G": g, "KV": kv, "d": hd,
            "lengths": lengths,
            "window": window,
            "max_abs_err": float(err.max()), "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_by": b_by,
            **times(lambda: decode_attention(q, k, v, lens, window),
                    lambda: decode_attention_ref(q, k, v, lens, window),
                    lib)}
        log(f"decode_attention {name} B={B} W={W} S={S} G={g} KV={kv} "
            f"d={hd} lengths={lengths} window={window}: {rows[name]}")
    return rows, worst


# ---------------------------------------------------------------------------
# Phases 3-5: the serving path at full width
# ---------------------------------------------------------------------------

PROMPT_LENS = (17, 40, 80, 65)     # prefill chunks 16 | 32,4,2,1 | 64,8,4,2,1 | 64
NEW_TOKENS = 32


def make_requests(cfg, lens, new_tokens):
    import numpy as np
    from repro_torch.serving.admission import Request
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=L),
                    new_tokens=new_tokens) for i, L in enumerate(lens)]


def serve(cfg, params, dev, reqs, max_len=256, **kw):
    import torch
    from repro_torch.kernels import LAUNCHES, WKV_FORMS, reset_launches
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, batch=2, window_max=8, block_size=16,
                        max_len=max_len, eps_key=1, use_verify_kernel=True,
                        device=dev, **kw)
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.uid} rejected: {r.error}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES, rwkv_wkv_forms=dict(WKV_FORMS))
    m = eng.export_metrics()
    if len(done) != len(reqs):
        raise AssertionError(f"served {len(done)} of {len(reqs)} requests")
    for r in done:
        if not r.ok or len(r.result) != len(r.prompt) + r.new_tokens:
            raise AssertionError(f"request {r.uid}: {r.error}")
        if not ((r.result >= 0).all() and (r.result < cfg.vocab).all()):
            raise AssertionError(f"request {r.uid}: tokens out of range")
        if not (r.result[:len(r.prompt)] == r.prompt).all():
            raise AssertionError(f"request {r.uid}: prompt not preserved")
    return done, m, wall, launches


# the profiler ranges ``MoETap`` and ``LayerTap`` open around a layer's or a
# pass's calls
RANGES = ("moe_layer", "mamba_layer", "attn_layer", "dense_ffn",
          "verify_pass", "prefill_chunk")


def kernel_times(prof):
    """(device µs, launches, name) of every kernel a ``torch.profiler``
    run recorded, longest first."""
    kern = []
    for evt in prof.key_averages():
        # the ranges the taps open have a device-side span too: not a kernel
        if ("CUDA" not in str(getattr(evt, "device_type", ""))
                or evt.key in RANGES):
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        kern.append((float(us), evt.count, evt.key))
    kern.sort(reverse=True)
    return kern


def range_split(prof):
    """The ``LayerTap`` ranges of a profiled run by the pass they ran in:
    {pass kind: {"passes": n, layer kind: {"calls", "device_us",
    "launches"}}}, pass kinds "verify_pass" and "prefill_chunk", layer
    kinds "mamba_layer", "attn_layer", "moe_layer" and "dense_ffn". A
    range's device time is that of the kernels launched inside it; its
    launches are the kernel-launch calls the host made inside it (CPU
    time containment on the same thread). Empty without the ranges."""
    import bisect
    events = [e for e in prof.events() if "CPU" in str(e.device_type)]
    launch = sorted((e.thread, e.time_range.start) for e in events
                    if e.name.startswith(("cudaLaunchKernel",
                                          "cuLaunchKernel")))
    passes = sorted(((e.thread, e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.name in ("verify_pass",
                                                   "prefill_chunk")))
    out = {}
    for _, _, _, kind in passes:
        out.setdefault(kind, {"passes": 0})["passes"] += 1
    for e in events:
        if e.name not in ("mamba_layer", "attn_layer", "moe_layer",
                          "dense_ffn"):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        i = bisect.bisect_right(passes, (e.thread, t0, float("inf"), "~")) - 1
        if i < 0 or passes[i][0] != e.thread or passes[i][2] < t1:
            continue
        n = (bisect.bisect_right(launch, (e.thread, t1))
             - bisect.bisect_left(launch, (e.thread, t0)))
        row = out[passes[i][3]].setdefault(
            e.name, {"calls": 0, "device_us": 0.0, "launches": 0})
        row["calls"] += 1
        row["device_us"] += e.device_time_total
        row["launches"] += n
    return out


class LayerTap:
    """Within ``with``: each Mamba layer (``Mamba.window`` and
    ``advance_state``), attention layer (``GQAttention.window`` and
    ``window_paged``), MoE layer (``MoE.apply``) and dense FFN (the
    decoder's ``_mlp_apply``) call runs in a profiler range named by its
    kind, and each verify round and prefill chunk of the serving engine in
    a range "verify_pass" or "prefill_chunk", which ``range_split`` reads.
    The port's code is not changed: its functions are put back on exit."""

    def __enter__(self):
        import torch
        import repro_torch.models.transformer as tr
        import repro_torch.serving.engine as se
        from repro_torch.models.attention import GQAttention
        from repro_torch.models.moe import MoE
        from repro_torch.models.ssm import Mamba
        eng = se.ServingEngine
        # (owner, attribute, range name); a class's staticmethods stay so
        taps = [(Mamba, "window", "mamba_layer"),
                (Mamba, "advance_state", "mamba_layer"),
                (GQAttention, "window", "attn_layer"),
                (GQAttention, "window_paged", "attn_layer"),
                (MoE, "apply", "moe_layer"), (tr, "_mlp_apply", "dense_ffn"),
                (se, "verify_round", "verify_pass"),
                (eng, "_prefill", "prefill_chunk")]
        self.saved = [(obj, attr, vars(obj)[attr])
                      for obj, attr, _ in taps]

        def ranged(name, fn):
            def call(*a, **kw):
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            return call
        for (obj, attr, name), (_, _, fn) in zip(taps, self.saved):
            if isinstance(fn, staticmethod):
                setattr(obj, attr, staticmethod(ranged(name, fn.__func__)))
            else:
                setattr(obj, attr, ranged(name, fn))
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in self.saved:
            setattr(obj, attr, fn)
        return False


def profile_serve(cfg, params, dev, lens=PROMPT_LENS[:2], max_len=256):
    """Where the time of a short serving run on the kernel path goes (2
    requests of prompts ``lens``, 16 new tokens each): the run once without
    the profiler for its wall time, then once under ``torch.profiler`` for
    the device busy time from its kernel records and the kernels that take
    the most. The idle share is taken against the unprofiled wall, since
    the profiler lengthens the host's time but not the kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = make_requests(cfg, lens, 16)
    _, m, wall, _ = serve(cfg, params, dev, reqs, max_len=max_len)
    reqs = make_requests(cfg, lens, 16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pm, pwall, _ = serve(cfg, params, dev, reqs, max_len=max_len)
    kern = kernel_times(prof)
    busy_s = sum(k[0] for k in kern) / 1e6
    # device time of each of the port's own kernels, by function name
    # (spec_verify's call runs spec_verify_partial and spec_verify_final)
    own = {}
    for name in ("spec_verify", "paged_decode", "paged_latent",
                 "paged_write", "rwkv_wkv"):
        hits = [(us, n) for us, n, key in kern if name + "_" in key]
        own[name] = {"us": sum(h[0] for h in hits),
                     "count": sum(h[1] for h in hits)}
    passes = m["rounds"] + m["prefill_calls"]
    # the MoE layers' device time: the kernels launched inside the ranges
    # ``MoETap`` opens around each ``MoE.apply`` (none without one)
    moe = [e for e in prof.events() if e.name == "moe_layer"
           and "CPU" in str(e.device_type)]
    out = {"wall_s": wall, "profiled_wall_s": pwall, "device_busy_s": busy_s,
           "ranges": range_split(prof),
           "moe_layer_device_us": sum(e.device_time_total for e in moe),
           "moe_layer_calls": len(moe),
           "idle_share": (1 - busy_s / wall) if kern else None,
           "profiled_idle_share": (1 - busy_s / pwall) if kern else None,
           "rounds": m["rounds"], "prefill_calls": m["prefill_calls"],
           "passes_equal": (pm["rounds"], pm["prefill_calls"])
           == (m["rounds"], m["prefill_calls"]),
           "tokens": m["tokens_generated"], "port_kernels": own,
           "top_kernels": [{"us": us, "count": n, "name": name[:90]}
                           for us, n, name in kern[:12]]}
    if not kern:
        log("profile: the profiler recorded no device time")
    else:
        log(f"profile (2 requests x 16 tokens, kernel path, {passes} passes: "
            f"{m['rounds']} rounds, {m['prefill_calls']} prefill chunks): "
            f"wall {wall:.3f} s unprofiled ({wall / passes * 1e3:.2f} ms per "
            f"pass), {pwall:.3f} s profiled; device busy {busy_s:.4f} s "
            f"({busy_s / passes * 1e3:.3f} ms per pass); idle share "
            f"{out['idle_share']:.4f} against the unprofiled wall, "
            f"{out['profiled_idle_share']:.4f} against the profiled one")
        for k in out["top_kernels"]:
            log(f"  {k['us'] / 1e3:9.3f} ms  x{k['count']:<6d} {k['name']}")
        log("  the port's kernels: " + ", ".join(
            f"{n} {v['us'] / 1e3:.3f} ms x{v['count']}"
            for n, v in own.items()))
    return out


def solo_agreement(cfg, params, dev, done, tol, routes=None, max_len=256,
                   **kw):
    """Each served request against the port's solo sampler (dense cache,
    plain attention or plain WKV scan, plain argmax: none of the port's
    kernels unless ``kw`` asks for them) on the card, under the margin
    rule; ``kw`` goes to the sampler (``use_forecast_heads``,
    ``use_attention_kernel``). Where the streams split within
    the tolerance, the solo sampler starts again from the engine's tokens
    up to and including that position (the noise depends only on the
    sequence and the position), so every new token is compared.

    An MoE model's routing is a discrete choice that a rounding can move:
    ``routes`` (the ``RouteLog`` of the served run) is then required, and a
    split whose reference margin is not below ``tol`` is also explained
    where ``routing_check`` finds a position up to it that the served run
    sent to other experts than the reference did, and the reference with
    the served routing pinned gives the served token or a margin below
    ``tol``."""
    import torch
    from repro_torch.engine.agreement import (check_token_agreement,
                                              top2_margin)
    from repro_torch.engine.spec_decode import PredictiveSampler, make_eps_fn
    from repro_torch.models.transformer import TransformerLM
    eps_fn = make_eps_fn(1, cfg.vocab)
    kw.setdefault("use_attention_kernel", False)
    moe = any(f == "moe" for _, f in cfg.layer_specs())
    if moe and routes is None:
        raise ValueError("an MoE model's agreement needs the served routing")
    out = []
    for r in sorted(done, key=lambda r: r.uid):
        end = len(r.prompt) + r.new_tokens
        start, splits = len(r.prompt), []
        served = routes.routes(r.seq_id, r.result) if moe else None
        while start < end:
            s = PredictiveSampler(cfg, params, window=8, max_len=max_len,
                                  eps_key=1, device=dev, **kw)
            ref, _ = s.generate(torch.as_tensor(r.result[:start])[None],
                                end - start, seq_ids=torch.tensor([r.seq_id]))
            ref = ref[0, :end].cpu().numpy()

            def margin_at(p, ref=ref, sid=r.seq_id):
                toks = torch.as_tensor(ref[:p], device=dev)[None]
                cache = TransformerLM.init_cache(cfg, 1, p, device=dev)
                logits, _, _ = TransformerLM.decode_window(
                    params, cfg, toks, cache,
                    torch.zeros(1, dtype=torch.int64, device=dev))
                e = eps_fn(torch.tensor([sid], device=dev),
                           torch.tensor([[p]], device=dev))
                return top2_margin((logits[0, -1].float() + e[0, 0]).cpu())
            # an MoE split past the margin is judged by its routing below
            res = check_token_agreement(ref, r.result, margin_at,
                                        math.inf if moe else tol,
                                        start=start)
            if res is None:
                break
            if not res["margin"] < tol:
                p = res["position"]
                chk = routing_check(cfg, params, dev, eps_fn,
                                    r.result[:p + 1], r.seq_id, served)
                res.update(chk)
                if not (chk["routing_differs_at"]
                        and (chk["pinned_token"] == int(r.result[p])
                             or chk["pinned_margin"] < tol)):
                    raise AssertionError(
                        f"request {r.uid}: streams differ at position {p} "
                        f"where the reference's top-2 margin "
                        f"{res['margin']:.4g} is not below {tol}, and the "
                        f"routing does not explain it: {chk}")
            splits.append(res)
            start = res["position"] + 1
        out.append({"uid": r.uid, "equal": not splits,
                    "compared": r.new_tokens, "splits": splits})
        routed = ""
        if moe:
            # the positions the two route differently, whole stream
            out[-1]["routing_differs_at"] = routing_check(
                cfg, params, dev, eps_fn, r.result, r.seq_id,
                served)["routing_differs_at"]
            routed = (f"; served routing differs from the reference's at "
                      f"{len(out[-1]['routing_differs_at'])} of {end - 1} "
                      f"positions")
        log(f"  request {r.uid}: {r.new_tokens} new tokens compared{routed}, "
            + ("equal to solo" if not splits else "split at " + ", ".join(
                f"{d['position']} (reference margin {d['margin']:.4g}, "
                f"tolerance {tol}"
                + (f"; served routing differs from the reference's at "
                   f"positions {d['routing_differs_at']}, pinned to it the "
                   f"reference gives token {d['pinned_token']} (served "
                   f"{int(r.result[d['position']])}), margin "
                   f"{d['pinned_margin']:.4g}" if "pinned_token" in d
                   else "") + ")" for d in splits)))
    return out


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return tree.numel()


def serve_deepseek(dev, tol):
    """Phase 6: DeepSeek-V3 at its published widths, cut in depth to its
    three dense-prefix MLA layers, served on the latent kernel's path with
    FPI forecasts and with the learned forecast heads, profiled, once on
    the gather fallback, and every request held against the solo sampler.
    Returns the phase's report and the launch counts of the FPI run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=3)
    t0 = time.perf_counter()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"{cfg.name} cut to {cfg.n_layers} layers {cfg.layer_specs()}: "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, latent "
        f"{cfg.kv_lora_rank} + rope {cfg.qk_rope_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.forecast_horizon} forecast heads, "
        f"{cfg.dtype}, {count_params(params) / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    serve(cfg, params, dev, make_requests(cfg, (17,), 4),
          use_forecast_heads=True)                    # warm-up
    out, fpi_launches = {}, None
    for label, kw in (("fpi", {}),
                      ("forecast_heads", {"use_forecast_heads": True})):
        reqs = make_requests(cfg, PROMPT_LENS, NEW_TOKENS)
        done, m, wall, launches = serve(cfg, params, dev, reqs, **kw)
        tok = m["tokens_generated"]
        log(f"serve deepseek ({label}, latent kernel path): {len(done)} "
            f"requests, {tok} new tokens, {m['rounds']} verify rounds "
            f"({m['rounds'] / tok:.4f} rounds per token), "
            f"{m['prefill_calls']} prefill chunks, arm_calls_vs_ancestral "
            f"{m['arm_calls_vs_ancestral']:.4f}, wall {wall:.3f} s "
            f"({wall / tok * 1e3:.2f} ms per token), launches {launches}")
        if (launches["paged_latent"] <= 0 or launches["spec_verify"] <= 0
                or launches["paged_decode"] != 0):
            raise AssertionError(f"latent kernel path not taken: {launches}")
        log(f"solo agreement, deepseek {label} (margin rule, tolerance "
            f"{tol}):")
        out[label] = {"metrics": m, "wall_s": wall, "launches": launches,
                      "ms_per_token": wall / tok * 1e3,
                      "agreement": solo_agreement(cfg, params, dev, done,
                                                  tol, **kw)}
        fpi_launches = fpi_launches or launches
    out["profile"] = profile_serve(cfg, params, dev)
    pl = out["profile"]["port_kernels"]["paged_latent"]
    out["paged_latent_profiled"] = pl
    log(f"paged_latent in the profiled run: {pl['us']:.1f} device us over "
        f"{pl['count']} launches"
        + (f" ({pl['us'] / pl['count']:.2f} us each)" if pl["count"] else ""))
    fb_reqs = make_requests(cfg, PROMPT_LENS[:1], 8)
    fb_done, fm, fwall, fb_launches = serve(cfg, params, dev, fb_reqs,
                                            use_attention_kernel=False)
    log(f"serve deepseek (gather fallback): {len(fb_done)} request, "
        f"{fm['tokens_generated']} new tokens, {fm['rounds']} verify rounds, "
        f"wall {fwall:.3f} s, launches {fb_launches}")
    if fb_launches["paged_write"] <= 0 or fb_launches["paged_latent"] != 0:
        raise AssertionError(f"fallback path not taken: {fb_launches}")
    log("solo agreement, deepseek gather fallback:")
    out["fallback"] = {"metrics": fm, "wall_s": fwall,
                       "launches": fb_launches,
                       "agreement": solo_agreement(cfg, params, dev, fb_done,
                                                   tol)}
    del params
    torch.cuda.empty_cache()
    return out, fpi_launches


# ---------------------------------------------------------------------------
# Phases 7-8: the training path at full width
# ---------------------------------------------------------------------------

def run_steps(cfg, step_fn, params, state, batches, label):
    """Runs ``step_fn`` over ``batches``; per step its metrics, wall ms and
    tokens/s (host clock around work that ends in a synchronize)."""
    import torch
    out = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        row = {k: float(v) for k, v in m.items()}
        row.update(ms=ms, tokens_per_s=batch.numel() / ms * 1e3)
        out.append(row)
        log(f"train {label} step {i + 1}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in row.items()))
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"train {label} step {i + 1}: non-finite "
                                 f"{bad}")
    return params, state, out


# Phase 7 holds the whole model's kernel route against its plain route by
# the logits and the per-position losses (the mean loss of random weights
# sits near ln V whatever attention computes). Both routes round to bf16
# between layers and the plain _sdpa rounds scores and probabilities to
# bf16 too, so the routes part by a few hundredths after 28 layers; each
# limit lies between that reading and the smaller of two planted faults',
# and the script fails if the gate would pass either fault.
ROUTE_LIMITS = {"logits_mean_abs_diff": 0.03, "logits_max_abs_diff": 0.25,
                "xent_per_position_max_abs_diff": 0.15}


def planted_fault(fault):
    """The flash op's function with one fault planted, in plain float32
    torch: ``kv_head_mod`` has query head h read kv head h % KV instead of
    h // G; ``kv_head_next`` has it read kv head h // G + 1 (mod KV), a
    fault that ``kv_head_mod`` cannot plant at G = 1 (multi-head
    attention); ``diagonal_tile_dropped`` has each 64-row query tile skip its
    last key tile, the diagonal one (a row that then sees no key gives 0);
    ``window_ignored`` attends over every earlier key, as a kernel that
    drops the sliding window would. The first two keep the window."""
    import torch

    def attend(q, k, v, window=0):
        B, T, H, d = q.shape
        heads = torch.arange(H, device=q.device)
        kv = heads // (H // k.shape[2])
        if fault == "kv_head_mod":
            kv = heads % k.shape[2]
        elif fault == "kv_head_next":
            kv = (kv + 1) % k.shape[2]
        pos = torch.arange(T, device=q.device)
        if fault == "diagonal_tile_dropped":
            mask = pos[None, :] < (pos[:, None] // 64) * 64
        else:
            mask = pos[None, :] <= pos[:, None]
        if window > 0 and fault != "window_ignored":
            mask &= pos[None, :] > pos[:, None] - window
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k[:, :, kv].float()) / d ** 0.5
        p = torch.softmax(s.masked_fill(~mask, -float("inf")), -1)
        p = torch.nan_to_num(p, nan=0.0)
        return torch.einsum("bhqk,bkhd->bqhd", p,
                            v[:, :, kv].float()).to(q.dtype)
    return attend


def route_diffs(params, cfg, tokens, module, name, faults, plain_op=None,
                prefix=None):
    """Logits and per-position loss differences from the plain route: of
    the kernel route and of each planted fault, a function put in place of
    the kernel's op ``module.name`` for one forward on the kernel route.
    The plain route is the model's (``use_kernel=False``), or with
    ``plain_op`` the kernel route with that function in the op's place.
    A frontend's ``prefix`` goes before the tokens, and its positions are
    dropped before the comparison, as ``lm_loss`` drops them."""
    import torch
    from repro_torch.models.transformer import TransformerLM
    tgt = tokens[:, 1:].long()[..., None]
    n_pre = 0 if prefix is None else prefix.shape[1]

    def forward(use_kernel, op=None):
        kernel_op = getattr(module, name)
        if op is not None:
            setattr(module, name, op)
        try:
            logits = TransformerLM.apply(params, cfg, tokens, prefix,
                                         use_kernel=use_kernel)[0]
            logits = logits[:, n_pre:]
        finally:
            setattr(module, name, kernel_op)
        lg = logits[:, :-1].float()
        return logits, (torch.logsumexp(lg, -1)
                        - torch.gather(lg, -1, tgt)[..., 0])

    plain, plain_pos = forward(plain_op is not None, plain_op)
    out = {}
    for route in ("kernel",) + tuple(faults):
        logits, per_pos = forward(True, faults.get(route))
        dl = (logits.float() - plain.float()).abs()
        dx = (per_pos - plain_pos).abs()
        out[route] = {"logits_mean_abs_diff": float(dl.mean()),
                      "logits_max_abs_diff": float(dl.max()),
                      "xent_per_position_max_abs_diff": float(dx.max()),
                      "xent_mean_diff": float((per_pos - plain_pos).mean()),
                      "xent_positions_differing": int((dx > 0).sum())}
        del logits, per_pos, dl, dx
    return out


def check_route_diffs(diffs, positions, limits):
    """Fails unless the kernel route is inside every limit of ``limits``
    and each planted fault is outside at least one."""
    for route, d in diffs.items():
        log(f"route {route} vs plain: logits mean |diff| "
            f"{d['logits_mean_abs_diff']:.4g}, max "
            f"{d['logits_max_abs_diff']:.4g}; per-position loss max |diff| "
            f"{d['xent_per_position_max_abs_diff']:.4g} at "
            f"{d['xent_positions_differing']} of {positions} positions")
    log(f"limits: {limits}")
    inside = {route: all(d[k] <= lim for k, lim in limits.items())
              for route, d in diffs.items()}
    if not inside["kernel"]:
        raise AssertionError(f"kernel route beyond {limits}: "
                             f"{diffs['kernel']}")
    caught = [r for r in inside if r != "kernel" and not inside[r]]
    if len(caught) != len(inside) - 1:
        raise AssertionError(f"the route gate passes a planted fault: "
                             f"{diffs}")


def train_qwen(dev):
    """Phase 7: qwen3-1.7b at full width, 3 AdamW steps at B = 2, S = 2048
    with the attention on the flash-attention kernel. Returns the phase's
    report and the launch counts of the 3 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_optimizer, make_train_step
    from repro_torch.models.losses import lm_loss
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config("qwen3-1.7b")
    B, S, steps = 2, 2048, 3
    params = TransformerLM.init(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, steps=steps)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)
    pipe = TokenPipeline(token_batches(max(512, B * 8), B, S, cfg.vocab),
                         dev)
    batches = [next(pipe) for _ in range(steps + 1)]
    out = {"B": B, "S": S, "optimizer": "adamw"}
    # step 1's loss on the plain attention route, from the same parameters
    # and batch, before the first update (the step updates them in place);
    # and how far the kernel route's logits and per-position losses part
    # from the plain route's, beside two routes with a planted fault
    with torch.no_grad():
        lp, _ = lm_loss(params, cfg, batches[0], use_kernel=False)
        out["route_diff"] = route_diffs(
            params, cfg, batches[0], attention, "flash_attention",
            {f: planted_fault(f) for f in ("kv_head_mod",
                                           "diagonal_tile_dropped")})
    out["plain_loss_step1"] = float(lp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    params, state, rows = run_steps(cfg, step_fn, params, state,
                                    batches[:steps], "qwen3-1.7b")
    launches = dict(LAUNCHES)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["steps"] = rows
    out["launches"] = launches
    log(f"train qwen3-1.7b: launches {launches} ({cfg.n_layers} flash "
        f"launches per forward x {steps} steps), peak memory "
        f"{out['peak_memory_gb']:.3f} GB")
    if launches["flash_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"flash launches {launches['flash_attention']}, "
                             f"want {cfg.n_layers} x {steps}")
    loss1 = rows[0]["loss"]
    ln_v = math.log(cfg.vocab)
    # random tied logits of std ~0.02 * sqrt(d_model) ~ 0.9 add about
    # var / 2 ~ 0.4 to ln V
    if abs(loss1 - ln_v) > 1.0:
        raise AssertionError(f"step-1 loss {loss1} not near ln V {ln_v}")
    # bf16 logits through 28 layers: the kernel keeps scores and
    # probabilities in float32 where the plain _sdpa rounds them to bf16;
    # the float32 mean over 4094 positions differs by far less than 1e-2
    out["loss_tolerance"] = 1e-2
    diff = abs(loss1 - out["plain_loss_step1"])
    log(f"step-1 loss: kernel path {loss1:.9g}, plain path "
        f"{out['plain_loss_step1']:.9g}, |diff| {diff:.3g} (tolerance "
        f"1e-2); ln V {ln_v:.4f}")
    if not diff <= out["loss_tolerance"]:
        raise AssertionError(f"step-1 loss: kernel {loss1} vs plain "
                             f"{out['plain_loss_step1']}")
    check_route_diffs(out["route_diff"], B * (S - 1), ROUTE_LIMITS)
    # one more step under the profiler: the busy share against the
    # unprofiled steps 2-3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, prow = run_steps(cfg, step_fn, params, state,
                                        batches[steps:], "profiled")
    kern = kernel_times(prof)
    busy_ms = sum(k[0] for k in kern) / 1e3
    step_ms = sum(r["ms"] for r in rows[1:]) / (steps - 1)
    flash = [(us, n) for us, n, key in kern if "flash_attention_" in key]
    out["profile"] = {
        "step_ms_unprofiled": step_ms, "step_ms_profiled": prow[0]["ms"],
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / step_ms if kern else None,
        "flash_attention_ms": sum(f[0] for f in flash) / 1e3,
        "flash_attention_launches": sum(f[1] for f in flash),
        "top_kernels": [{"ms": us / 1e3, "count": n, "name": name[:90]}
                        for us, n, name in kern[:12]]}
    if not kern:
        log("profile: the profiler recorded no device time")
    else:
        pr = out["profile"]
        log(f"profile of one train step: device busy {busy_ms:.2f} ms of "
            f"{step_ms:.2f} ms unprofiled ({prow[0]['ms']:.2f} profiled); "
            f"busy share {pr['busy_share']:.4f}; flash_attention "
            f"{pr['flash_attention_ms']:.3f} ms over "
            f"{pr['flash_attention_launches']} launches")
        for k in pr["top_kernels"]:
            log(f"  {k['ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    del params, state
    torch.cuda.empty_cache()
    return out, launches


def train_deepseek(dev, tol):
    """Phase 8: DeepSeek-V3 at its published widths cut to its three
    dense-prefix MLA layers, 2 Adafactor steps of the LM loss plus the
    forecast-KL objective at B = 1, S = 512; the trained parameters saved
    with ``save_pytree``, loaded back (bitwise), and one request of 8
    tokens served from them with the forecast heads."""
    import shutil
    import torch
    from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                           reference_tree, save_pytree)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.train import make_optimizer, make_train_step
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim.optimizers import tree_leaves
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=3)
    B, S, steps = 1, 512, 2
    params = TransformerLM.init(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, steps=steps)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)
    pipe = TokenPipeline(token_batches(512, B, S, cfg.vocab), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state, rows = run_steps(cfg, step_fn, params, state,
                                    [next(pipe) for _ in range(steps)],
                                    "deepseek-v3 (3 layers)")
    out = {"B": B, "S": S, "optimizer": "adafactor", "steps": rows,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if "forecast_kl" not in rows[0]:
        raise AssertionError("no forecast_kl in the metrics")
    del state
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save_pytree(reference_tree(params, cfg), str(ckpt), steps)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = params_from_numpy(load_pytree(str(ckpt), steps), cfg,
                                   device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(loaded)))
    log(f"train deepseek: peak memory {out['peak_memory_gb']:.3f} GB; "
        f"checkpoint saved in {out['save_s']:.1f} s, loaded in "
        f"{out['load_s']:.1f} s, bitwise equal: {same}")
    if not same:
        raise AssertionError("the loaded checkpoint differs from the "
                             "trained parameters")
    del params
    torch.cuda.empty_cache()
    done, m, wall, launches = serve(cfg, loaded, dev,
                                    make_requests(cfg, (17,), 8),
                                    use_forecast_heads=True)
    log(f"serve deepseek from the trained checkpoint (forecast heads): "
        f"{m['tokens_generated']} new tokens, {m['rounds']} verify rounds, "
        f"wall {wall:.3f} s, launches {launches}, tokens "
        f"{done[0].result[-8:].tolist()}")
    if launches["paged_latent"] <= 0 or launches["spec_verify"] <= 0:
        raise AssertionError(f"latent kernel path not taken: {launches}")
    out["serve"] = {"metrics": m, "wall_s": wall, "launches": launches,
                    "agreement": solo_agreement(cfg, loaded, dev, done, tol,
                                                use_forecast_heads=True)}
    del loaded
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 9-10: RWKV-6 serving and the solo sampler's dense cache
# ---------------------------------------------------------------------------

# Phase 9 holds the whole rwkv6-7b kernel route at T = 1024 by the logits
# and the per-position losses against two plain routes, each beside two
# planted faults the gate must catch. RWKV_ROUTE_LIMITS: against the
# model's plain route, the reference's scan, which rounds the state to bf16
# at every step and so loses much of the decay (1 - w is near 2^-9, below
# half a bf16 ulp of the state); the kernel keeps it in float32, so the
# two part widely and the limits sit between that reading and the nearer
# fault. RWKV_OP_LIMITS: against the WKV op's float32 plain version put in
# the kernel's place, which computes the kernel's own function, so the
# routes part only by the order of sums and the limits are tight.
RWKV_ROUTE_LIMITS = {"logits_mean_abs_diff": 0.53,
                     "logits_max_abs_diff": 5.0,
                     "xent_per_position_max_abs_diff": 2.55}
RWKV_OP_LIMITS = {"logits_mean_abs_diff": 0.1,
                  "logits_max_abs_diff": 1.0,
                  "xent_per_position_max_abs_diff": 0.5}


def wkv_planted_fault(fault):
    """The WKV op's function with one fault planted, in its plain
    version's float32: ``bonus_dropped`` has u = 0 (y_t reads S_{t-1}
    alone); ``kv_transposed`` has k and v trade places, so the state is
    accumulated transposed."""
    import torch
    from repro_torch.kernels.rwkv_wkv.ref import rwkv_wkv_ref

    def op(r, k, v, w, u, state0=None, states="none"):
        if fault == "bonus_dropped":
            return rwkv_wkv_ref(r, k, v, w, torch.zeros_like(u), state0,
                                states)
        return rwkv_wkv_ref(r, v, k, w, u, state0, states)
    return op


def serve_rwkv(dev, cfg, tol, route_T=1024):
    """Phase 9: rwkv6-7b served at full width (random weights from seed 0)
    on the WKV kernel's path, 32 launches per verify pass and per prefill
    chunk, profiled, every request held against the solo sampler on the
    WKV kernel and on the plain scan; then ``TransformerLM.apply`` at
    B = 1, T = ``route_T`` on the kernel route against the plain scan and
    against the op's plain version, each gated beside two planted faults.
    Returns the phase's report and the serving run's launches."""
    import torch
    import repro_torch.models.ssm as ssm
    from repro_torch.kernels.rwkv_wkv.ref import rwkv_wkv_ref
    from repro_torch.models.transformer import TransformerLM
    t0 = time.perf_counter()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"{cfg.name}: {cfg.n_layers} layers {cfg.layer_specs()[0]}, d_model "
        f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
        f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"params": n_params}
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))     # warm-up
    reqs = make_requests(cfg, PROMPT_LENS, NEW_TOKENS)
    done, m, wall, launches = serve(cfg, params, dev, reqs)
    tok = m["tokens_generated"]
    passes = m["verify_passes"] + m["prefill_calls"]
    log(f"serve {cfg.name} (WKV kernel path): {len(done)} requests, {tok} "
        f"new tokens, {m['rounds']} verify rounds ({m['rounds'] / tok:.4f} "
        f"rounds per token), {m['verify_passes']} verify passes, "
        f"{m['prefill_calls']} prefill chunks, arm_calls_vs_ancestral "
        f"{m['arm_calls_vs_ancestral']:.4f}, wall {wall:.3f} s "
        f"({wall / tok * 1e3:.2f} ms per token, {wall / passes * 1e3:.2f} "
        f"ms per pass), launches {launches}")
    if launches["rwkv_wkv"] != cfg.n_layers * passes \
            or launches["spec_verify"] <= 0:
        raise AssertionError(f"rwkv_wkv launches {launches['rwkv_wkv']}, "
                             f"want {cfg.n_layers} x {passes} passes")
    # by form: every position's state in a verify pass, the last state in
    # a prefill chunk
    forms = launches["rwkv_wkv_forms"]
    want = {"none": 0, "all": cfg.n_layers * m["verify_passes"],
            "last": cfg.n_layers * m["prefill_calls"]}
    log(f"rwkv_wkv launches by form: {forms} (verify form = {cfg.n_layers} "
        f"x {m['verify_passes']} verify passes, prefill form = "
        f"{cfg.n_layers} x {m['prefill_calls']} prefill chunks)")
    if forms != want:
        raise AssertionError(f"rwkv_wkv launches by form {forms}, want "
                             f"{want}")
    out["serve"] = {"metrics": m, "wall_s": wall, "launches": launches,
                    "ms_per_token": wall / tok * 1e3,
                    "ms_per_pass": wall / passes * 1e3}
    out["profile"] = profile_serve(cfg, params, dev)
    log(f"solo agreement, {cfg.name}, against the solo sampler on the WKV "
        f"kernel (margin rule, tolerance {tol}):")
    out["agreement_kernel"] = solo_agreement(cfg, params, dev, done, tol,
                                             use_attention_kernel=True)
    # the plain scan parts from the kernel route by its bf16 rounding of the
    # state; where two routes' logits differ by at most L, their argmax can
    # differ only where the top-2 margin is below 2 L: L is measured on the
    # served streams themselves
    gap = route_logit_gap(params, cfg, dev, done)
    tol_plain = 2 * gap
    log(f"largest |logit difference| of the kernel and plain routes over "
        f"the served streams: {gap:.4g}; solo agreement against the solo "
        f"sampler on the plain scan (margin rule, tolerance 2 x that = "
        f"{tol_plain:.4g}):")
    out["route_logit_gap"] = gap
    out["agreement_plain"] = solo_agreement(cfg, params, dev, done,
                                            tol_plain)
    tokens = torch.randint(0, cfg.vocab, (1, route_T), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               1))
    faults = {f: wkv_planted_fault(f) for f in ("bonus_dropped",
                                                "kv_transposed")}
    with torch.no_grad():
        out["route_diff"] = route_diffs(params, cfg, tokens, ssm,
                                        "rwkv_wkv", faults)
        out["op_route_diff"] = route_diffs(params, cfg, tokens, ssm,
                                           "rwkv_wkv", faults,
                                           plain_op=rwkv_wkv_ref)
    log("kernel route against the model's plain scan (bf16 state):")
    check_route_diffs(out["route_diff"], route_T - 1, RWKV_ROUTE_LIMITS)
    log("kernel route against the WKV op's float32 plain version:")
    check_route_diffs(out["op_route_diff"], route_T - 1, RWKV_OP_LIMITS)
    del params
    torch.cuda.empty_cache()
    return out, launches


def route_logit_gap(params, cfg, dev, done):
    """The largest |difference| between the kernel route's and the plain
    route's logits (``TransformerLM.apply``) at the generated positions of
    the served streams."""
    import torch
    from repro_torch.models.transformer import TransformerLM
    gap = 0.0
    with torch.no_grad():
        for r in done:
            toks = torch.as_tensor(r.result[:-1], device=dev)[None]
            lg = [TransformerLM.apply(params, cfg, toks, use_kernel=k)[0][
                0, len(r.prompt) - 1:].float() for k in (True, False)]
            gap = max(gap, float((lg[0] - lg[1]).abs().max()))
    return gap


def solo_dense(dev, cfg, served, tol):
    """Phase 10: the solo sampler (``PredictiveSampler``, dense cache) on
    qwen3-1.7b at full width with the dense flash-decode kernel in its
    prompt prefill and every verify round, one request at a time: 28
    launches per pass; its tokens against the plain solo sampler and the
    kernel-route sampler against phase 3's served tokens, both under the
    margin rule. Returns the phase's report and the summed launches."""
    import torch
    from repro_torch.engine.spec_decode import PredictiveSampler
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import TransformerLM
    params = TransformerLM.init(cfg, seed=0, device=dev)
    reqs = make_requests(cfg, PROMPT_LENS, NEW_TOKENS)
    total = {k: 0 for k in LAUNCHES}
    rows, wall, n_tok = [], 0.0, 0
    for r in reqs:
        s = PredictiveSampler(cfg, params, window=8, max_len=256, eps_key=1,
                              device=dev, use_verify_kernel=True,
                              use_attention_kernel=True)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        toks, st = s.generate(torch.as_tensor(r.prompt)[None], r.new_tokens,
                              seq_ids=torch.tensor([r.seq_id]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        passes = st["rounds"] + (len(r.prompt) > 1)
        n = LAUNCHES["decode_attention"]
        for k in total:
            total[k] += LAUNCHES[k]
        if n != cfg.n_layers * passes:
            raise AssertionError(f"request {r.uid}: decode_attention "
                                 f"launches {n}, want {cfg.n_layers} x "
                                 f"{passes} passes")
        r.result = toks[0, :len(r.prompt) + r.new_tokens].cpu().numpy()
        wall += dt
        n_tok += r.new_tokens
        rows.append({"uid": r.uid, "prompt": len(r.prompt),
                     "rounds": st["rounds"], "passes": passes,
                     "decode_attention_launches": n, "wall_s": dt})
        log(f"solo (dense flash-decode kernel) request {r.uid}: prompt "
            f"{len(r.prompt)}, {r.new_tokens} new tokens in {st['rounds']} "
            f"rounds, {passes} passes, {n} decode_attention launches, "
            f"{dt:.3f} s")
    log(f"solo dense path: {n_tok} new tokens, {wall / n_tok * 1e3:.2f} ms "
        f"per token, launches {total}")
    out = {"requests": rows, "wall_s": wall, "launches": total,
           "ms_per_token": wall / n_tok * 1e3}
    log(f"agreement with the plain solo sampler (margin rule, tolerance "
        f"{tol}):")
    out["agreement_plain"] = solo_agreement(cfg, params, dev, reqs, tol)
    log(f"agreement of the kernel-route solo sampler with phase 3's served "
        f"tokens (margin rule, tolerance {tol}):")
    out["agreement_served"] = solo_agreement(cfg, params, dev, served, tol,
                                             use_attention_kernel=True)
    del params
    torch.cuda.empty_cache()
    return out, total


# ---------------------------------------------------------------------------
# Phases 11-12: the samplers of the paper's Tables 1 and 2 at full width
# ---------------------------------------------------------------------------

# the samplers of the paper's Table 1 (benchmarks/table1_image.py's
# methods, with Algorithm 2 beside them); "baseline" is ancestral sampling
IMAGE_METHODS = ("baseline", "zeros", "last", "fpi", "alg2", "learned")
# training steps at batch 32: enough for the loss to fall well clear of its
# noise, few enough that both phases stay near 300 s on the card
MNIST_STEPS, CIFAR_STEPS, AE_STEPS, LATENT_STEPS = 300, 150, 400, 200
# the autoencoder's rate: at the ARMs' 2e-3 (the reference's, which trains
# it at reduced widths) the full-width encoder collapses onto one code per
# latent position, and the latent ARM then has nothing to model
AE_LR = 3e-4
# the equality gate's control: briefly trained ARMs barely read their
# context, and every sampler equals ancestral sampling trivially where the
# context decides no sample. Untrained binary_mnist with its logits x16
# (the output layer's weights) lets the context decide far more samples
# than the noise alone; at least CONTROL_MIN_SHARE of them must change
# with another sample's context (``context_report``)
CONTROL_SHARPEN, CONTROL_MIN_SHARE = 16.0, 0.2


def arm_flops(cfg) -> int:
    """Operations of one PixelCNN forward per image, 2·H·W·Σ k²·c_in·c_out
    over its convolutions (masked weights included: the convolutions
    compute them)."""
    C, K, F = cfg.channels, cfg.categories, cfg.filters
    taps = (cfg.first_kernel ** 2 * C * K * F
            + cfg.n_res * cfg.kernel ** 2 * (2 * F * F + 2 * F * 2 * F)
            + 2 * F * C * K)
    return 2 * cfg.height * cfg.width * taps


def assert_on_card(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise AssertionError(f"a tensor of the paper's path is on "
                                 f"{t.device}, not the card")


def train_loop(label, tree, loss_fn, data, steps, lr=2e-3, batch=32,
               seed=0):
    """``steps`` AdamW(``lr``) steps of ``loss_fn(tree, batch) -> loss`` on
    random batches of the on-card ``data``, the frozen leaves (``_mask``)
    zeroed, as the reference's ``benchmarks/common.py`` trains; the mean
    loss of the last 10 steps must fall below 0.95 x the first 10's.
    Returns the trained tree and a report (losses, seconds)."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
    opt = optim.adamw(lr)
    state = opt.init(tree)
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, data.shape[0],
                                        size=(steps, batch))).to(data.device)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(steps):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
        loss = loss_fn(tree_unflatten(tree, leaves), data[idx[s]])
        grads = optim.zero_frozen(tree_unflatten(
            tree, torch.autograd.grad(loss, leaves)))
        tree, state = opt.step(grads, state, tree)
        losses.append(loss.detach())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = torch.stack(losses).cpu().tolist()
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    log(f"train {label}: {steps} steps at batch {batch} in {secs:.2f} s "
        f"({secs / steps * 1e3:.2f} ms per step); loss, mean of the first "
        f"10 steps {first:.5f}, of the last 10 {last:.5f}")
    if not last < 0.95 * first:
        raise AssertionError(f"{label}: the loss did not fall ({first} -> "
                             f"{last})")
    return tree, {"steps": steps, "batch": batch, "seconds": secs,
                  "first10": first, "last10": last}


def init_pixelcnn(cfg, fcfg, dev):
    """The ARM and its forecast, drawn from seed 0."""
    import torch
    from repro_torch.core.forecasting import PixelForecast
    from repro_torch.models.pixelcnn import PixelCNN
    gen = torch.Generator(device=dev).manual_seed(0)
    return {"arm": PixelCNN.init(gen, cfg, device=dev),
            "forecast": PixelForecast.init(gen, fcfg, device=dev)}


def train_pixelcnn(label, cfg, fcfg, data, steps, dev):
    """The ARM and its forecast trained jointly on the on-card ``data``
    (bits/dim + 0.01 x the forecast KL, ``models/losses.py:
    pixelcnn_loss``)."""
    from repro_torch.models.losses import pixelcnn_loss
    tree = init_pixelcnn(cfg, fcfg, dev)
    assert_on_card(data, tree["arm"]["in_conv"]["w"])
    return train_loop(
        label, tree, lambda t, b: pixelcnn_loss(t["arm"], t["forecast"], b,
                                                cfg, fcfg)[0], data, steps)


def busy_union_s(prof):
    """Seconds in which at least one kernel ran: the union of the device
    events' intervals (kernels on several streams, as cuDNN's FFT
    convolutions run, overlap, so their summed times can exceed the
    wall)."""
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events()
                if "CUDA" in str(getattr(e, "device_type", "")))
    total, end = 0.0, -math.inf
    for a, b in iv:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def triangular_check(arm, cfg, dev, B=2):
    """Strict triangular dependence, bitwise, at full width: for j in 0,
    d/2 and d-1, changing x[:, j], and separately redrawing every input
    from j on, leaves logits[:, :j+1] unchanged to the bit."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(0, cfg.categories, (B, cfg.d), generator=gen,
                      device=dev)
    base, _ = arm(x)
    js = (0, cfg.d // 2, cfg.d - 1)
    for j in js:
        one = x.clone()
        one[:, j] = (one[:, j] + 1) % cfg.categories
        rest = x.clone()
        rest[:, j:] = torch.randint(0, cfg.categories, (B, cfg.d - j),
                                    generator=gen, device=dev)
        for what, x2 in (("x[:, j]", one), ("x[:, j:]", rest)):
            pert, _ = arm(x2)
            if not torch.equal(pert[:, :j + 1], base[:, :j + 1]):
                bad = (pert[:, :j + 1] != base[:, :j + 1]).any(-1)
                raise AssertionError(
                    f"changing {what} at j = {j} moved the logits of "
                    f"positions {bad.nonzero()[:4, 1].tolist()}...")
    log(f"strict triangular dependence bitwise at full width (d = "
        f"{cfg.d}, B = {B}, j in {js}, one input and every input from j)")
    return {"j": list(js), "B": B, "bitwise": True}


def context_report(label, cfg, arm, params, data, eps, x):
    """How far the ARM's samples rest on their context: its bits/dim on 64
    of its training ``data`` beside the data's per-position marginal
    entropy (the bits/dim of the best model that ignores the context), and
    the share of the ancestral samples ``x``'s positions whose sample
    changes, under the same ``eps``, when the context is another sample's
    (0 for an ARM that ignores its context: every sampler then equals
    ancestral sampling whatever its forecasts)."""
    import torch
    from repro_torch.core.reparam import reparam_argmax
    from repro_torch.models.pixelcnn import PixelCNN
    K, d, n = cfg.categories, cfg.d, data.shape[0]
    with torch.no_grad():
        bpd = float(PixelCNN.bpd(params, data[:64], cfg))
        other, _ = arm(x.roll(1, 0))
        share = float((reparam_argmax(other, eps) != x).float().mean())
    at = data.reshape(n, d).long() + K * torch.arange(d, device=data.device)
    p = torch.bincount(at.reshape(-1), minlength=d * K).reshape(
        d, K).double() / n
    marginal = float(-(p * torch.log2(p.clamp_min(1e-300))).sum() / d)
    log(f"  {label}: {bpd:.4f} bits/dim on 64 training images, "
        f"{marginal:.4f} under the data's per-position marginals; "
        f"another sample's context changes {share:.4f} of the samples "
        f"(B = {x.shape[0]})")
    return {"bpd": bpd, "marginal_bpd": marginal, "context_share": share}


def sample_table(label, cfg, tree, fcfg, methods, dev, data):
    """Each method at batch 1 and 16 with one shared eps per batch (the
    port's threefry Gumbel noise), after a warm-up of two ARM calls per
    method; every method's samples must equal ancestral sampling's
    bitwise. Returns a row per (batch, method): % ARM calls, wall seconds
    per sampled batch, ms per ARM call and its float32 FLOP bound. Each
    method's timed run is its only full run (ancestral sampling's warm-up
    is the others': it runs the same ARM calls). One fpi run at batch 16
    is profiled for the device's busy share; ``context_report`` of the
    ancestral samples at batch 16 on the ``data``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import predictive_sampling as ps
    from repro_torch.core import random as jr
    from repro_torch.core import reparam
    from repro_torch.core.forecasting import PixelForecast
    from repro_torch.models.pixelcnn import PixelCNN
    arm = PixelCNN.make_arm_fn(tree["arm"], cfg)
    learned = ps.make_learned_forecast(
        PixelForecast.module_fn(tree["forecast"], fcfg),
        window=fcfg.horizon * cfg.channels, group=cfg.channels)
    fc = {"zeros": ps.zeros_forecast, "last": ps.predict_last_forecast,
          "fpi": ps.fpi_forecast, "learned": learned}

    def run(method, eps, max_iters=None):
        if method == "baseline":
            return ps.ancestral_sample(arm, eps)
        if method == "alg2":
            return ps.fixed_point_sample(arm, eps, max_iters)
        return ps.predictive_sample(arm, fc[method], eps, max_iters)

    flops = arm_flops(cfg)
    rows, out = [], {"arm_gflop_per_image": flops / 1e9}
    for B in (1, 16):
        eps = reparam.gumbel(jr.fold_in(jr.prng_key(7, device=dev), B),
                             (B, cfg.d, cfg.categories))
        assert_on_card(eps)
        for m in methods:
            if m != "baseline":
                run(m, eps, max_iters=2)
        ref = None
        for m in methods:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, stats = run(m, eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert_on_card(x)
            if m == "baseline":
                ref = x
                if not ((x >= 0) & (x < cfg.categories)).all():
                    raise AssertionError(f"{label}: samples out of range")
                if B == 16:
                    out["context"] = context_report(label, cfg, arm,
                                                    tree["arm"], data, eps,
                                                    x)
            elif not torch.equal(x, ref):
                n_bad = int((x != ref).sum())
                raise AssertionError(
                    f"{label} B={B}: {m} differs from ancestral sampling at "
                    f"{n_bad} positions")
            if (stats.per_sample_calls > stats.arm_calls).any():
                raise AssertionError(f"{label} {m}: per-sample calls")
            calls = stats.arm_calls
            row = {"batch": B, "method": m, "arm_calls": calls,
                   "calls_pct": 100.0 * calls / cfg.d, "wall_s": wall,
                   "ms_per_call": wall / calls * 1e3,
                   "bound_ms_per_call": flops * B / PEAK_OPS["float32"]
                   * 1e3,
                   "per_sample_calls_mean": float(
                       stats.per_sample_calls.float().mean())}
            rows.append(row)
            log(f"  {label} B={B:<2d} {m:8s} {calls:5d} ARM calls "
                f"({row['calls_pct']:6.2f}% of d = {cfg.d}), {wall:8.3f} s "
                f"per batch, {row['ms_per_call']:7.3f} ms per call (float32 "
                f"bound {row['bound_ms_per_call']:.3f} ms), equal to "
                f"ancestral: {'reference' if m == 'baseline' else 'bitwise'}")
        if B == 16:
            fpi_wall = next(r["wall_s"] for r in rows
                            if r["batch"] == B and r["method"] == "fpi")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run("fpi", eps)
                torch.cuda.synchronize()
            kern = kernel_times(prof)
            busy = busy_union_s(prof)
            out["fpi_profile"] = {
                "batch": B, "device_busy_s": busy, "wall_s": fpi_wall,
                "kernel_time_sum_s": sum(k[0] for k in kern) / 1e6,
                "busy_share": busy / fpi_wall if kern else None,
                "top_kernels": [{"ms": us / 1e3, "count": n,
                                 "name": name[:90]}
                                for us, n, name in kern[:8]]}
            if not kern:
                log("profile: the profiler recorded no device time")
            else:
                log(f"  {label} fpi B={B} profiled: device busy {busy:.4f} s "
                    f"of {fpi_wall:.4f} s unprofiled, busy share "
                    f"{busy / fpi_wall:.4f}")
                for k in out["fpi_profile"]["top_kernels"][:5]:
                    log(f"    {k['ms']:9.3f} ms  x{k['count']:<6d} "
                        f"{k['name']}")
    out["rows"] = rows
    return out


def table1(dev):
    """Phase 11: Table 1's samplers at full width. binary_mnist (28x28x1,
    K = 2, 60 filters, 2 blocks; T = 20) and cifar10_8bit (32x32x3, K =
    256, 162 filters, 5 blocks; T = 5), each trained jointly with its
    forecast on the synthetic stand-ins, then sampled by every method at
    batch 1 and 16, bitwise against ancestral sampling; between them the
    control (``CONTROL_SHARPEN``)."""
    import torch
    from repro_torch.configs.paper import PIXELCNN_FULL, forecast_cfg
    from repro_torch.data.synthetic import binary_strokes, quantized_textures
    from repro_torch.models.pixelcnn import PixelCNN
    out = {}
    t0 = time.perf_counter()
    cfg = PIXELCNN_FULL["binary_mnist"]
    fcfg = forecast_cfg(cfg, 20)
    data = torch.from_numpy(binary_strokes(2048, 28, 28, seed=0)).to(dev)
    tree, out["mnist_train"] = train_pixelcnn(
        "binary_mnist", cfg, fcfg, data, MNIST_STEPS, dev)
    out["mnist_triangular"] = triangular_check(
        PixelCNN.make_arm_fn(tree["arm"], cfg), cfg, dev)
    out["mnist"] = sample_table("binary_mnist", cfg, tree, fcfg,
                                IMAGE_METHODS, dev, data)
    tree = init_pixelcnn(cfg, fcfg, dev)
    tree["arm"]["out_conv"]["w"] *= CONTROL_SHARPEN
    out["control"] = sample_table("control", cfg, tree, fcfg, IMAGE_METHODS,
                                  dev, data)
    share = out["control"]["context"]["context_share"]
    if share < CONTROL_MIN_SHARE:
        raise AssertionError(f"the control's samples rest on their context "
                             f"at {share} of positions, below "
                             f"{CONTROL_MIN_SHARE}: its gate is weak")
    cfg = PIXELCNN_FULL["cifar10_8bit"]
    fcfg = forecast_cfg(cfg, 5)
    data = torch.from_numpy(quantized_textures(1024, 32, 32, 3, 256,
                                               seed=1)).to(dev)
    tree, out["cifar_train"] = train_pixelcnn(
        "cifar10_8bit", cfg, fcfg, data, CIFAR_STEPS, dev)
    out["cifar"] = sample_table("cifar10_8bit", cfg, tree, fcfg,
                                ("baseline", "fpi", "learned"), dev, data)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11 took {out['seconds']:.1f} s")
    return out


def table2(dev):
    """Phase 12: Table 2's samplers at full width. The discrete
    autoencoder (32x32x3, width 512, 8x8x4 latents of K = 128) trained on
    MSE twice from one seed, the two bitwise equal (the codes the encoder
    comes to use, and all that follows, hang on the last bit: ``main``
    sets cuDNN's deterministic algorithms), frozen, its latents encoded;
    the latent PixelCNN (160 filters, 5 blocks) trained with a T = 1
    forecast on them and sampled as in phase 11."""
    import torch
    from repro_torch.configs.paper import (AE_FULL, LATENT_ARM_FULL,
                                           forecast_cfg)
    from repro_torch.data.synthetic import quantized_textures
    from repro_torch.models.autoencoder import DiscreteAutoencoder as AE
    from repro_torch.optim.optimizers import tree_leaves
    out = {}
    t0 = time.perf_counter()
    imgs = torch.from_numpy(quantized_textures(1024, 32, 32, 3, 256,
                                               seed=3)).to(dev)
    x = imgs.float() / 127.5 - 1.0

    def train_ae():
        gen = torch.Generator(device=dev).manual_seed(0)
        return train_loop(
            "autoencoder (MSE)", AE.init(gen, AE_FULL, device=dev),
            lambda p, b: AE.mse_loss(p, b, AE_FULL), x, AE_STEPS, AE_LR)

    ae, out["ae_train"] = train_ae()
    again, _ = train_ae()
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(ae),
                                                  tree_leaves(again))):
        raise AssertionError("two trainings of the autoencoder from one "
                             "seed part")
    log("the autoencoder trained twice from one seed: bitwise equal")
    with torch.no_grad():
        xhat, z = AE.reconstruct(ae, x[:16], AE_FULL)
        h, w = AE_FULL.latent_hw
        if xhat.shape != x[:16].shape or z.shape != (
                16, h, w, AE_FULL.latent_channels):
            raise AssertionError(f"decode(encode): {tuple(xhat.shape)}, "
                                 f"{tuple(z.shape)}")
        if not torch.isfinite(xhat).all():
            raise AssertionError("non-finite reconstruction")
        # the frozen encoder's latent dataset
        z = torch.cat([AE.quantize(AE.encode_logits(ae, x[s:s + 256],
                                                    AE_FULL))[0]
                       for s in range(0, x.shape[0], 256)])
        assert_on_card(z)
        out["ae_mse_eval"] = float(torch.mean(torch.square(
            x[:16] - xhat)))
    out["latent_codes_used"] = int(torch.unique(z).numel())
    log(f"latents {tuple(z.shape)}, {out['latent_codes_used']} of "
        f"{AE_FULL.latent_categories} codes used; reconstruction MSE "
        f"{out['ae_mse_eval']:.5f}")
    lat = LATENT_ARM_FULL
    fcfg = forecast_cfg(lat, 1)
    tree, out["arm_train"] = train_pixelcnn(
        "latent ARM", lat, fcfg, z, LATENT_STEPS, dev)
    out["latent"] = sample_table("latent ARM", lat, tree, fcfg,
                                 ("baseline", "fpi", "learned"), dev, z)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 12 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the mixture-of-experts layer at published widths
# ---------------------------------------------------------------------------

class MoETap:
    """Within ``with``: each ``MoE.apply`` call runs in a profiler range
    "moe_layer", each ``MoE.route`` call's expert ids are kept in ``ids``
    and, with ``keep``, each ``MoE.plan`` call's keep mask in ``keeps``.
    With ``pin`` (ids recorded by another tap) the route calls take those
    ids in call order instead of their own top-k, and their weights from
    their own scores at those ids: two forwards then make the same
    discrete routing choices. The port's code is not changed: the class's
    functions are swapped here and put back on exit."""

    def __init__(self, pin=None, keep=False):
        self.pin, self.record_keep = pin, keep
        self.ids, self.keeps = [], []

    def __enter__(self):
        import torch
        from repro_torch.models.moe import MoE
        route, plan, apply = MoE.route, MoE.plan, MoE.apply
        self.saved = (route, plan, apply)
        tap = self

        def route_(p, x, cfg):
            ids, w, probs = route(p, x, cfg)
            if tap.pin is not None:
                ids = tap.pin[len(tap.ids) % len(tap.pin)]
                logits = (x @ p["router"]["w"]).float()
                scores = (torch.sigmoid(logits)
                          if cfg.router_score == "sigmoid"
                          else torch.softmax(logits, -1))
                w = torch.gather(scores, 1, ids.long())
                w = w / (w.sum(-1, keepdim=True) + 1e-9)
            tap.ids.append(ids)
            return ids, w, probs

        def plan_(ids, C):
            out = plan(ids, C)
            if tap.record_keep:
                tap.keeps.append(out[3])
            return out

        def apply_(*a, **kw):
            with torch.profiler.record_function("moe_layer"):
                return apply(*a, **kw)
        MoE.route, MoE.plan, MoE.apply = (staticmethod(route_),
                                          staticmethod(plan_),
                                          staticmethod(apply_))
        return self

    def __exit__(self, *exc):
        from repro_torch.models.moe import MoE
        MoE.route, MoE.plan, MoE.apply = (staticmethod(f)
                                          for f in self.saved)
        return False


class RouteLog:
    """Within ``with``: the expert ids every MoE layer chose in the serving
    engine's and the solo sampler's passes, to be read by (sequence,
    position) with ``routes``. ``verify_round`` (as the engine and the
    sampler call it) and the two prefills are wrapped to learn each row's
    sequence and whether it is active, ``TransformerLM.decode_window`` to
    learn each row's tokens and first position, and ``MoE.route`` to keep
    its ids, all on the device: the run gains a few small copies a pass
    and no host sync. The port's code is not changed: its functions are
    put back on exit."""

    def __init__(self):
        self.calls, self.ctx, self.cur, self.host = [], None, None, None

    def __enter__(self):
        import torch
        import repro_torch.engine.spec_decode as sd
        import repro_torch.serving.engine as se
        from repro_torch.models.moe import MoE
        from repro_torch.models.transformer import TransformerLM
        tap = self
        verify = sd.verify_round
        prefill = se.ServingEngine._prefill
        init_state = sd.PredictiveSampler.init_state
        window, route = TransformerLM.decode_window, MoE.route
        self.saved = [(sd, "verify_round", verify),
                      (se, "verify_round", se.verify_round),
                      (se.ServingEngine, "_prefill", prefill),
                      (sd.PredictiveSampler, "init_state", init_state),
                      (TransformerLM, "decode_window",
                       TransformerLM.__dict__["decode_window"]),
                      (MoE, "route", MoE.__dict__["route"])]

        def within(ctx, fn, *a, **kw):
            tap.ctx = ctx
            try:
                return fn(*a, **kw)
            finally:
                tap.ctx = None

        def verify_(params, cfg, eps_fn, state, target_len, **kw):
            return within((state.seq_ids, state.n < target_len), verify,
                          params, cfg, eps_fn, state, target_len, **kw)

        def prefill_(eng, table_row, b, chunk, start):
            return within((torch.tensor([int(eng.seq_ids[b])]),
                           torch.ones(1, dtype=torch.bool)), prefill,
                          eng, table_row, b, chunk, start)

        def init_state_(smp, prompts, batch, seq_ids=None):
            seq = (torch.arange(batch) if seq_ids is None
                   else torch.as_tensor(seq_ids))
            return within((seq, torch.ones(batch, dtype=torch.bool)),
                          init_state, smp, prompts, batch, seq_ids=seq_ids)

        def window_(params, cfg, tokens, cache, cache_len, *a, **kw):
            if tap.ctx is None:
                return window(params, cfg, tokens, cache, cache_len, *a,
                              **kw)
            seq, active = tap.ctx
            tap.cur = {"seq": seq.clone(), "active": active.clone(),
                       "pos0": cache_len.clone(), "tokens": tokens.clone(),
                       "ids": []}
            tap.calls.append(tap.cur)
            try:
                return window(params, cfg, tokens, cache, cache_len, *a,
                              **kw)
            finally:
                tap.cur = None

        def route_(p, x, cfg):
            out = route(p, x, cfg)
            if tap.cur is not None:
                tap.cur["ids"].append(out[0].clone())
            return out
        sd.verify_round = se.verify_round = verify_
        se.ServingEngine._prefill = prefill_
        sd.PredictiveSampler.init_state = init_state_
        TransformerLM.decode_window = staticmethod(window_)
        MoE.route = staticmethod(route_)
        return self

    def __exit__(self, *exc):
        for obj, name, f in self.saved:
            setattr(obj, name, f)
        return False

    def routes(self, seq, stream):
        """{position q: (MoE layers, k) expert ids} of sequence ``seq``,
        whose final tokens are ``stream``: from the first pass that
        computed q with every window input up to q equal to the stream's.
        That is the pass whose logits at q chose token q + 1: a prefill's
        inputs are the prompt, and the next verify pass starts past the
        positions whose inputs this one had right."""
        import torch
        if self.host is None:
            self.host = [{k: ([i.cpu() for i in v] if k == "ids"
                              else v.cpu()) for k, v in c.items()}
                         for c in self.calls]
        out = {}
        for c in self.host:
            if not c["ids"]:
                continue
            B, W = c["tokens"].shape
            ids = torch.stack(c["ids"]).view(len(c["ids"]), B, W, -1)
            for b in ((c["seq"] == seq) & c["active"]).nonzero()[:, 0]:
                p0 = int(c["pos0"][b])
                for j in range(W):
                    q = p0 + j
                    if q >= len(stream) or int(c["tokens"][b, j]) != int(
                            stream[q]):
                        break
                    out.setdefault(q, ids[:, b, j])
        return out


def routing_check(cfg, params, dev, eps_fn, stream, seq, served):
    """The served token ``stream[p]`` (p = len(stream) - 1) against the
    reference's routing: the reference recomputes positions 0..p-1 in one
    window on the plain routes, once with its own routing and once with
    every MoE layer pinned (``MoETap``) to ``served``, the served run's ids
    by position (``RouteLog.routes``). Returns the positions whose expert
    sets differ in some MoE layer (``routing_differs_at``), and the token
    and top-2 margin of ``logits + eps`` at p with the routing pinned
    (``pinned_token``, ``pinned_margin``)."""
    import torch
    from repro_torch.engine.agreement import top2_margin
    from repro_torch.models.transformer import TransformerLM
    p = len(stream) - 1
    missing = [q for q in range(p) if q not in served]
    if missing:
        raise AssertionError(f"served routing not recorded at {missing}")
    pins = torch.stack([served[q] for q in range(p)], 1).to(dev)
    toks = torch.as_tensor(stream[:p], device=dev)[None]
    e = eps_fn(torch.tensor([seq], device=dev),
               torch.tensor([[p]], device=dev))[0, 0]

    def last_scores(tap):
        cache = TransformerLM.init_cache(cfg, 1, p, device=dev)
        with tap:
            logits, _, _ = TransformerLM.decode_window(
                params, cfg, toks, cache,
                torch.zeros(1, dtype=torch.int64, device=dev))
        return (logits[0, -1].float() + e).cpu()
    own = MoETap()
    last_scores(own)
    pinned = last_scores(MoETap(pin=list(pins)))
    same = (torch.stack(own.ids).sort(-1).values
            == pins.sort(-1).values).all(-1).all(0)
    return {"routing_differs_at": (~same).nonzero()[:, 0].tolist(),
            "pinned_token": int(torch.argmax(pinned)),
            "pinned_margin": top2_margin(pinned)}


def moe_layer_times(cfg, p, dev):
    """Device ms of one ``MoE.apply`` call (no-drop, as serving runs it)
    at the verify shape (B = 2, W = 8) and a 64-token prefill chunk, on
    the layer's parameters ``p``, beside the byte bound of the expert
    weights every call reads (the batched products read all E experts'
    up, gate and down, whichever slots are filled) and the operations of
    the (E, C, D) products."""
    import torch
    from repro_torch.models.moe import MoE
    E, k, D, F_ = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    n_mats = len(p["experts"])
    w_bytes = sum(t.numel() * t.element_size()
                  for t in p["experts"].values())
    out = {"expert_bytes": w_bytes,
           "expert_byte_bound_ms": w_bytes / MEM_BYTES_PER_S * 1e3}
    for name, B, W in (("verify", 2, 8), ("prefill", 1, 64)):
        x = torch.randn((B, W, D), device=dev).to(cfg.param_dtype)
        N = B * W
        C = MoE.capacity(N, cfg, None)
        flops = 2 * n_mats * E * C * D * F_
        useful = 2 * n_mats * N * k * D * F_
        ms = device_ms(lambda: MoE.apply(p, x, cfg, capacity_factor=None),
                       iters=5, reps=3)
        out[name] = {"N": N, "C": C, "ms": ms, "tflop": flops / 1e12,
                     "useful_gflop": useful / 1e9,
                     "op_bound_ms": flops / PEAK_OPS["bfloat16"] * 1e3}
    log(f"MoE layer (E {E}, k {k}, D {D}, F {F_}), no-drop: expert weights "
        f"{w_bytes / 1e9:.3f} GB, byte bound "
        f"{out['expert_byte_bound_ms']:.4g} ms; verify (N 16, C "
        f"{out['verify']['C']}): {out['verify']['ms']:.4g} device ms, "
        f"{out['verify']['tflop']:.4g} TFLOP (useful "
        f"{out['verify']['useful_gflop']:.4g} GFLOP); prefill (N 64, C "
        f"{out['prefill']['C']}): {out['prefill']['ms']:.4g} ms, "
        f"{out['prefill']['tflop']:.4g} TFLOP")
    return out


def experts_hit(ids_list):
    """Distinct experts a call's tokens were routed to, by the call's
    token count: {N: [min, mean, max]}."""
    import torch
    by_n = {}
    for ids in ids_list:
        by_n.setdefault(int(ids.shape[0]), []).append(
            int(torch.unique(ids).numel()))
    return {n: [min(v), sum(v) / len(v), max(v)] for n, v in
            sorted(by_n.items())}


def serve_moe(dev, tol, arch, n_layers, latent):
    """Phase 13 (a) or (b): ``arch`` at its published widths cut to
    ``n_layers``, served on the attention kernel's path (the latent kernel
    with FPI and with the forecast heads, or paged_decode), profiled with
    the MoE layers' device time and the experts each call hits, once on the
    gather fallback (the writeback kernel), and every request held against
    the solo sampler under the margin rule (on decode_attention for a GQA
    model, the plain solo sampler for the latent one), a split past the
    margin judged by the served routing (``RouteLog``, kept during the
    served runs, their walls included). Returns the report and the
    launches of the path's main run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    t0 = time.perf_counter()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_moe = sum(f == "moe" for _, f in cfg.layer_specs())
    out = {"layers": [list(sp) for sp in cfg.layer_specs()],
           "params_b": count_params(params) / 1e9,
           "param_gb": torch.cuda.memory_allocated() / 1e9}
    log(f"{cfg.name} cut to {cfg.n_layers} layers {cfg.layer_specs()}: "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
        f"{cfg.n_experts} experts + {cfg.n_shared_experts} shared, top "
        f"{cfg.top_k} ({cfg.router_score}), expert d_ff {cfg.moe_d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, {out['params_b']:.3f} B params "
        f"({out['param_gb']:.2f} GB), init {time.perf_counter() - t0:.1f} s")
    moe_p = params["layers"][[f for _, f in cfg.layer_specs()].index("moe")]
    out["moe_layer"] = moe_layer_times(cfg, moe_p["ffn"], dev)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))       # warm-up
    runs = [("fpi", {})] + ([("forecast_heads", {"use_forecast_heads": True})]
                            if latent else [])
    main_launches = None
    for label, kw in runs:
        reqs = make_requests(cfg, PROMPT_LENS, NEW_TOKENS)
        with RouteLog() as routes:
            done, m, wall, launches = serve(cfg, params, dev, reqs, **kw)
        tok = m["tokens_generated"]
        passes = m["verify_passes"] + m["prefill_calls"]
        log(f"serve {cfg.name} {n_layers}L ({label}): {len(done)} requests, "
            f"{tok} new tokens, {m['rounds']} verify rounds "
            f"({m['rounds'] / tok:.4f} per token), {m['prefill_calls']} "
            f"prefill chunks, arm_calls_vs_ancestral "
            f"{m['arm_calls_vs_ancestral']:.4f}, wall {wall:.3f} s "
            f"({wall / tok * 1e3:.2f} ms per token), launches {launches}")
        kern, other = (("paged_latent", "paged_decode") if latent
                       else ("paged_decode", "paged_latent"))
        if not (launches[kern] == cfg.n_layers * passes
                and launches["spec_verify"] > 0 and launches[other] == 0):
            raise AssertionError(f"{cfg.name}: kernel path not taken as "
                                 f"expected ({passes} passes): {launches}")
        solo_kw = dict(kw) if latent else dict(kw, use_attention_kernel=True)
        torch.cuda.synchronize()
        reset_launches()
        solo_route = "plain attention" if latent else "decode_attention"
        log(f"solo agreement, {cfg.name} {label} (margin rule, tolerance "
            f"{tol}, solo on {solo_route}):")
        agreement = solo_agreement(cfg, params, dev, done, tol,
                                   routes=routes, **solo_kw)
        solo_launches = dict(LAUNCHES)
        if not latent and solo_launches["decode_attention"] <= 0:
            raise AssertionError(f"solo sampler not on decode_attention: "
                                 f"{solo_launches}")
        out[label] = {"metrics": m, "wall_s": wall, "launches": launches,
                      "ms_per_token": wall / tok * 1e3,
                      "rounds_per_token": m["rounds"] / tok,
                      "agreement": agreement, "solo_launches": solo_launches}
        main_launches = main_launches or launches
    with MoETap() as tap:
        out["profile"] = profile_serve(cfg, params, dev)
    pr = out["profile"]
    passes = pr["rounds"] + pr["prefill_calls"]
    # the profiled run is the second of profile_serve's two: its route calls
    # are the last half of those the tap saw
    hit = experts_hit(tap.ids[len(tap.ids) // 2:])
    out["moe_profile"] = {
        "device_ms_per_pass": pr["moe_layer_device_us"] / 1e3 / passes,
        "calls": pr["moe_layer_calls"], "moe_layers": n_moe,
        "byte_bound_ms_per_pass": n_moe
        * out["moe_layer"]["expert_byte_bound_ms"],
        "experts_hit_by_tokens": hit}
    log(f"MoE layers in the profiled run: "
        f"{out['moe_profile']['device_ms_per_pass']:.4g} device ms per pass "
        f"({n_moe} MoE layers; byte bound of their expert weights "
        f"{out['moe_profile']['byte_bound_ms_per_pass']:.4g} ms), "
        f"{pr['moe_layer_calls']} calls; distinct experts hit per call by "
        f"its token count, [min, mean, max]: {hit}")
    fb_reqs = make_requests(cfg, PROMPT_LENS[:1], 8)
    with RouteLog() as fb_routes:
        fb_done, fm, fwall, fb_launches = serve(cfg, params, dev, fb_reqs,
                                                use_attention_kernel=False)
    log(f"serve {cfg.name} (gather fallback): {fm['tokens_generated']} new "
        f"tokens, {fm['rounds']} verify rounds, wall {fwall:.3f} s, "
        f"launches {fb_launches}")
    if (fb_launches["paged_write"] <= 0 or fb_launches["paged_decode"] != 0
            or fb_launches["paged_latent"] != 0):
        raise AssertionError(f"fallback path not taken: {fb_launches}")
    log(f"solo agreement, {cfg.name} gather fallback (plain solo):")
    out["fallback"] = {"metrics": fm, "wall_s": fwall,
                       "launches": fb_launches,
                       "agreement": solo_agreement(cfg, params, dev, fb_done,
                                                   tol, routes=fb_routes)}
    del params, moe_p
    torch.cuda.empty_cache()
    return out, main_launches


def train_dbrx(dev):
    """Phase 13 (c): dbrx-132b at its published widths cut to 2 layers, 3
    Adafactor steps at B = 2, S = 2048 with capacity 1.25 and the attention
    on the flash-attention kernel. The kernel route's logits and per-
    position losses are held against the plain attention route within
    ``ROUTE_LIMITS`` with the MoE routing pinned to the plain route's (a
    routing choice within a rounding of a tie would otherwise move whole
    positions), beside the two planted attention faults; the unpinned
    routes' differences are reported. Returns the report and the launches
    of the 3 steps."""
    import torch
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_optimizer, make_train_step
    from repro_torch.models.losses import lm_loss
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=2)
    B, S, steps = 2, 2048, 3
    params = TransformerLM.init(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, steps=steps)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)
    pipe = TokenPipeline(token_batches(max(512, B * 8), B, S, cfg.vocab),
                         dev)
    batches = [next(pipe) for _ in range(steps)]
    out = {"B": B, "S": S, "optimizer": "adafactor", "capacity": 1.25,
           "params_b": count_params(params) / 1e9}
    with torch.no_grad():
        with MoETap() as plain_tap:
            lp, mp = lm_loss(params, cfg, batches[0], use_kernel=False)
        with MoETap() as kernel_tap:
            lk, _ = lm_loss(params, cfg, batches[0])
        flips = [int((a != b).any(-1).sum())
                 for a, b in zip(plain_tap.ids, kernel_tap.ids)]
        out["unpinned"] = {
            "loss_plain": float(lp), "loss_kernel": float(lk),
            "loss_diff": abs(float(lk) - float(lp)),
            "tokens_routed_differently_per_layer": flips}
        log(f"train dbrx unpinned: loss plain {float(lp):.6g}, kernel "
            f"{float(lk):.6g}; tokens whose experts differ between the "
            f"routes, per MoE layer: {flips} of {B * S}")
        with MoETap(pin=plain_tap.ids):
            out["route_diff"] = route_diffs(
                params, cfg, batches[0], attention, "flash_attention",
                {f: planted_fault(f) for f in ("kv_head_mod",
                                               "diagonal_tile_dropped")})
    out["plain_loss_step1"] = float(lp)
    check_route_diffs(out["route_diff"], B * (S - 1), ROUTE_LIMITS)
    pinned = abs(out["route_diff"]["kernel"]["xent_mean_diff"])
    log(f"pinned routing: mean loss difference kernel vs plain {pinned:.3g} "
        f"(tolerance 1e-2, as phase 7)")
    if not pinned <= 1e-2:
        raise AssertionError(f"pinned mean loss difference {pinned}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with MoETap(keep=True) as tap:
        params, state, rows = run_steps(cfg, step_fn, params, state, batches,
                                        "dbrx-132b (2 layers)")
    launches = dict(LAUNCHES)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_moe = sum(f == "moe" for _, f in cfg.layer_specs())
    dropped = [1 - float(torch.stack([k.float().mean() for k in
                                      tap.keeps[i * n_moe:(i + 1) * n_moe]])
                         .mean()) for i in range(steps)]
    out.update(steps=rows, launches=launches, dropped_share=dropped,
               moe_aux=[r["moe_aux"] for r in rows])
    log(f"train dbrx: launches {launches}, peak memory "
        f"{out['peak_memory_gb']:.3f} GB, moe_aux {out['moe_aux']}, share "
        f"of token-slots dropped per step {dropped}, step-1 loss "
        f"{rows[0]['loss']:.6g} (plain route {float(lp):.6g})")
    if launches["flash_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"flash launches {launches['flash_attention']}, "
                             f"want {cfg.n_layers} x {steps}")
    ln_v = math.log(cfg.vocab)
    if abs(rows[0]["xent"] - ln_v) > 2.0 or not rows[0]["moe_aux"] > 0:
        raise AssertionError(f"step 1: xent {rows[0]['xent']} vs ln V "
                             f"{ln_v}, moe_aux {rows[0]['moe_aux']}")
    del params, state
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# Phase 14: the remaining dense configs (gemma3-1b, gemma-2b, a
# mistral-large-123b depth cut) at head width 256 and group 12
# ---------------------------------------------------------------------------

# prompts past gemma3-1b's 512-key window (one inside it), and the engine
# length that holds them: prefill chunks and verify windows see keys the
# window hides on the local layers and keys it does not on the global ones
DENSE_PROMPT_LENS = (520, 600, 700, 300)
DENSE_MAX_LEN = 1024
DENSE_NB = -(-(DENSE_MAX_LEN + 8) // BS)      # the engine's table width: 65


def serve_dense(dev, tol, arch, n_layers=None):
    """Phase 14 (a)-(c): ``arch`` at its published widths (cut to
    ``n_layers`` where given) served in ``ServingEngine(batch=2,
    window_max=8, block_size=16, max_len=1024)`` on paged_decode (one launch
    per layer per verify pass and prefill chunk, asserted), profiled, once
    on the gather fallback (paged_write), and every request held against
    the solo sampler under the margin rule on decode_attention and on the
    plain route. Returns the report and the launches of the kernel path's
    run and of the kernel-route solo sampler's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    mixers = [m for m, _ in cfg.layer_specs()]
    out = {"layers": cfg.n_layers, "local_layers": mixers.count("local"),
           "window": cfg.sliding_window, "G": cfg.n_heads // cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "vocab": cfg.vocab,
           "params_b": count_params(params) / 1e9,
           "param_gb": torch.cuda.memory_allocated() / 1e9}
    log(f"{cfg.name}: {cfg.n_layers} layers ({out['local_layers']} local at "
        f"window {cfg.sliding_window}), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, {out['params_b']:.3f} B params "
        f"({out['param_gb']:.2f} GB), init {time.perf_counter() - t0:.1f} s")
    kw = dict(max_len=DENSE_MAX_LEN)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4), **kw)   # warm-up
    reqs = make_requests(cfg, DENSE_PROMPT_LENS, NEW_TOKENS)
    done, m, wall, launches = serve(cfg, params, dev, reqs, **kw)
    tok = m["tokens_generated"]
    passes = m["verify_passes"] + m["prefill_calls"]
    log(f"serve {cfg.name}: {len(done)} requests (prompts "
        f"{DENSE_PROMPT_LENS}), {tok} new tokens, {m['rounds']} verify "
        f"rounds ({m['rounds'] / tok:.4f} per token), {m['prefill_calls']} "
        f"prefill chunks, arm_calls_vs_ancestral "
        f"{m['arm_calls_vs_ancestral']:.4f}, wall {wall:.3f} s "
        f"({wall / tok * 1e3:.2f} ms per token), launches {launches}")
    if not (launches["paged_decode"] == cfg.n_layers * passes
            and launches["spec_verify"] > 0
            and launches["paged_latent"] == 0):
        raise AssertionError(f"{cfg.name}: paged_decode launched "
                             f"{launches['paged_decode']} times, not "
                             f"{cfg.n_layers} x {passes} passes: {launches}")
    out.update(metrics=m, wall_s=wall, launches=launches,
               ms_per_token=wall / tok * 1e3,
               rounds_per_token=m["rounds"] / tok)
    out["profile"] = profile_serve(cfg, params, dev, DENSE_PROMPT_LENS[:2],
                                   DENSE_MAX_LEN)
    torch.cuda.synchronize()
    reset_launches()
    log(f"solo agreement, {cfg.name} (margin rule, tolerance {tol}, solo on "
        f"decode_attention):")
    out["agreement_kernel_solo"] = solo_agreement(
        cfg, params, dev, done, tol, use_attention_kernel=True, **kw)
    solo_launches = dict(LAUNCHES)
    if solo_launches["decode_attention"] <= 0:
        raise AssertionError(f"solo sampler not on decode_attention: "
                             f"{solo_launches}")
    out["solo_launches"] = solo_launches
    log(f"solo agreement, {cfg.name} (margin rule, tolerance {tol}, plain "
        f"solo):")
    out["agreement_plain_solo"] = solo_agreement(cfg, params, dev, done, tol,
                                                 **kw)
    fb_reqs = make_requests(cfg, DENSE_PROMPT_LENS[:1], 8)
    fb_done, fm, fwall, fb_launches = serve(cfg, params, dev, fb_reqs,
                                            use_attention_kernel=False, **kw)
    log(f"serve {cfg.name} (gather fallback): {fm['tokens_generated']} new "
        f"tokens, {fm['rounds']} verify rounds, wall {fwall:.3f} s, "
        f"launches {fb_launches}")
    if fb_launches["paged_write"] <= 0 or fb_launches["paged_decode"] != 0:
        raise AssertionError(f"fallback path not taken: {fb_launches}")
    log(f"solo agreement, {cfg.name} gather fallback (plain solo):")
    out["fallback"] = {"metrics": fm, "wall_s": fwall,
                       "launches": fb_launches,
                       "agreement": solo_agreement(cfg, params, dev, fb_done,
                                                   tol, **kw)}
    del params
    torch.cuda.empty_cache()
    return out, launches, solo_launches, fb_launches


def train_gemma3(dev):
    """Phase 14 (d): gemma3-1b at full width, 3 AdamW steps at B = 2,
    S = 2048 with the attention on the flash-attention kernel: 26 launches
    per forward, 22 of them at the 512-key window. The step-1 logits and
    per-position losses of the kernel route are held against the plain
    route within ``ROUTE_LIMITS``, beside two planted faults the gate must
    catch: one drops the window, one the diagonal key tile (gemma3-1b's one
    kv head leaves ``kv_head_mod`` nothing to break). Returns the report
    and the launches of the 3 steps."""
    import torch
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_optimizer, make_train_step
    from repro_torch.models.losses import lm_loss
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config("gemma3-1b")
    B, S, steps = 2, 2048, 3
    params = TransformerLM.init(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, steps=steps)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)
    pipe = TokenPipeline(token_batches(max(512, B * 8), B, S, cfg.vocab),
                         dev)
    batches = [next(pipe) for _ in range(steps)]
    out = {"B": B, "S": S, "optimizer": "adamw",
           "params_b": count_params(params) / 1e9}
    with torch.no_grad():
        lp, _ = lm_loss(params, cfg, batches[0], use_kernel=False)
        out["route_diff"] = route_diffs(
            params, cfg, batches[0], attention, "flash_attention",
            {f: planted_fault(f) for f in ("window_ignored",
                                           "diagonal_tile_dropped")})
    out["plain_loss_step1"] = float(lp)
    check_route_diffs(out["route_diff"], B * (S - 1), ROUTE_LIMITS)
    # the windows the model hands the op, by call
    windows, kernel_op = [], attention.flash_attention

    def counted(q, k, v, window=0):
        windows.append(window)
        return kernel_op(q, k, v, window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    attention.flash_attention = counted
    try:
        params, state, rows = run_steps(cfg, step_fn, params, state, batches,
                                        "gemma3-1b")
    finally:
        attention.flash_attention = kernel_op
    launches = dict(LAUNCHES)
    by_window = {w: windows.count(w) for w in sorted(set(windows))}
    out.update(steps=rows, launches=launches, calls_by_window=by_window,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"train gemma3-1b: launches {launches}, flash calls by window "
        f"{by_window}, peak memory {out['peak_memory_gb']:.3f} GB")
    n_local = sum(m == "local" for m, _ in cfg.layer_specs())
    if launches["flash_attention"] != cfg.n_layers * steps or by_window != {
            0: (cfg.n_layers - n_local) * steps,
            cfg.sliding_window: n_local * steps}:
        raise AssertionError(f"flash launches {launches['flash_attention']}"
                             f", by window {by_window}, want {cfg.n_layers} "
                             f"x {steps}, {n_local} local")
    loss1 = rows[0]["loss"]
    diff = abs(loss1 - out["plain_loss_step1"])
    log(f"step-1 loss: kernel path {loss1:.9g}, plain path "
        f"{out['plain_loss_step1']:.9g}, |diff| {diff:.3g} (tolerance "
        f"1e-2, as phase 7); ln V {math.log(cfg.vocab):.4f}")
    if not diff <= 1e-2 or abs(loss1 - math.log(cfg.vocab)) > 1.0:
        raise AssertionError(f"step-1 loss: kernel {loss1} vs plain "
                             f"{out['plain_loss_step1']}")
    del params, state
    torch.cuda.empty_cache()
    return out, launches


def check_dense_kernels(dev, gen):
    """Phase 14 (e): the kernels at the dense configs' shapes against their
    plain versions, with device times, bounds and library times: flash
    attention at gemma3-1b's training shape (4 query heads over one kv head
    of 256, window 512 and none) and gemma-2b's 8 heads; decode_attention
    and paged_decode at gemma3-1b's verify shape and 64-wide prefill chunk
    with window 512 over lengths that pass it, and gemma-2b's group of 8;
    paged_decode at mistral-large-123b's group of 12; paged_write at
    gemma's 512-byte rows; spec_verify over the three vocabularies."""
    hd, nb = 256, DENSE_NB
    out = {}
    out["flash_attention"], _ = check_flash_attention(dev, gen, (
        ("gemma3_local", 2, 2048, 512, 4, 1, hd),
        ("gemma3_global", 2, 2048, 0, 4, 1, hd),
        ("gemma2b_train", 2, 2048, 0, 8, 1, hd)), backward=False)
    out["decode_attention"], _ = check_decode_attention(dev, gen, (
        ("gemma3_verify", 2, 8, DENSE_MAX_LEN, [700, 520], 512, 4, 1, hd),
        ("gemma3_prefill", 1, 64, DENSE_MAX_LEN, [600], 512, 4, 1, hd),
        ("gemma2b_verify", 2, 8, DENSE_MAX_LEN, [700, 300], 0, 8, 1, hd)))
    out["paged_decode"], _ = check_paged_decode(dev, gen, (
        ("gemma3_verify", 2, 8, [700, 520], 512, 4, nb, 1, hd),
        ("gemma3_prefill", 1, 64, [600], 512, 4, nb, 1, hd),
        ("gemma2b_verify", 2, 8, [700, 300], 0, 8, nb, 1, hd),
        ("mistral_verify", 2, 8, [700, 300], 0, 12, nb, KV, D)))
    out["paged_write"] = check_paged_write(dev, gen, (
        ("gemma_verify", (2, 8, [700, 520], [1, 1]), (1, hd), nb),
        ("gemma_prefill", (1, 64, [600], [1]), (1, hd), nb)))
    out["spec_verify"] = check_spec_verify(dev, gen, (
        (16, 262144), (16, 256000), (16, 32768)))
    return out


# ---------------------------------------------------------------------------
# Phase 15: the Mamba mixer and a jamba-1.5-large-398b depth cut
# ---------------------------------------------------------------------------

JAMBA_LAYERS = 4       # the cut: the first 4 layers of the 8-layer block


def jamba_cut():
    """jamba-1.5-large-398b at its published widths cut to its first
    ``JAMBA_LAYERS`` layers: (mamba, dense), (mamba, moe), (mamba, dense),
    (attn, moe). ``ModelConfig.n_blocks`` takes whole blocks, so the block
    itself is cut."""
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(cfg, n_layers=JAMBA_LAYERS,
                               layer_block=cfg.layer_block[:JAMBA_LAYERS])


def check_jamba_kernels(dev, gen):
    """Phase 15 (d): the three kernels of the jamba path at its shapes
    against their plain versions, with device times, bounds and library
    times: paged_decode at the verify window and a 64-wide prefill chunk
    (64 query heads over 8 kv heads of 128, G = 8, over the engine's
    65-block table), decode_attention at the solo sampler's verify window
    (its dense cache of 1024 + 8 slots) and spec_verify over 16 rows of
    jamba's 65,536-token vocabulary."""
    g = 8
    out = {}
    out["paged_decode"], _ = check_paged_decode(dev, gen, (
        ("jamba_verify", 2, 8, [700, 520], 0, g, DENSE_NB, KV, D),
        ("jamba_prefill", 1, 64, [600], 0, g, DENSE_NB, KV, D)))
    out["decode_attention"], _ = check_decode_attention(dev, gen, (
        ("jamba_verify", 2, 8, DENSE_MAX_LEN + 8, [700, 520], 0, g, KV, D),))
    out["spec_verify"] = check_spec_verify(dev, gen, ((16, 65536),))
    return out


def layer_bytes(cfg, params):
    """Bytes of the weights one pass reads, by layer kind: the Mamba
    layers' projections and conv, the attention layer's projections, the
    MoE layers' router and all E experts (no-drop reads every expert), the
    dense FFNs', beside the layer counts."""
    out = {}
    for (mixer, ffn), p in zip(cfg.layer_specs(), params["layers"]):
        for kind, tree in (("mamba_layer" if mixer == "mamba"
                            else "attn_layer", p["mixer"]),
                           ("moe_layer" if ffn == "moe" else "dense_ffn",
                            p["ffn"])):
            row = out.setdefault(kind, {"layers": 0, "bytes": 0})
            row["layers"] += 1
            row["bytes"] += count_bytes(tree)
    for row in out.values():
        row["byte_bound_ms"] = row["bytes"] / MEM_BYTES_PER_S * 1e3
    return out


def count_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def two_pass_check(cfg, params, dev, rounds=3):
    """Phase 15 (c): verify rounds through ``make_serve_step`` with
    ``low_memory=False`` (one pass, ``select_states``) and ``True`` (the
    logits pass, then the window again with every recurrent update frozen
    past the accept point), from the same dense cache (a 300-token prompt
    per row, prefilled by the solo sampler on decode_attention), each
    round's window the last round's outputs (fixed-point iteration, so the
    accept counts grow). The tokens and accept counts must be equal
    bitwise, and every Mamba layer's conv and h states too; the largest
    state difference is logged either way."""
    import numpy as np
    import torch
    from repro_torch.engine.spec_decode import PredictiveSampler
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import make_serve_step
    W = 8
    rng = np.random.default_rng(2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           size=(2, DENSE_PROMPT_LENS[3])))
    smp = PredictiveSampler(cfg, params, window=W, max_len=DENSE_MAX_LEN,
                            eps_key=1, device=dev, use_attention_kernel=True)
    st = smp.init_state(prompts, 2)
    cache_len = st.n - 1
    eps = smp.eps_fn(st.seq_ids, st.n[:, None] + torch.arange(W, device=dev))
    one = make_serve_step(cfg, W, low_memory=False, use_kernel=True)
    two = make_serve_step(cfg, W, low_memory=True, use_kernel=True)
    mamba = [i for i, (m, _) in enumerate(cfg.layer_specs()) if m == "mamba"]
    cand, rows = st.cand, []
    torch.cuda.synchronize()
    reset_launches()
    for r in range(rounds):
        out1, acc1, sel = one(params, cand, st.cache, cache_len, eps)
        out2, acc2, adv = two(params, cand, st.cache, cache_len, eps)
        diff, equal = 0.0, True
        for i in mamba:
            for k in ("conv", "h"):
                a = sel["layers"][i]["mixer"][k]
                b = adv["layers"][i]["mixer"][k]
                equal &= bool(torch.equal(a, b))
                diff = max(diff, float((a.float() - b.float()).abs().max()))
        row = {"round": r, "accept": acc1.tolist(),
               "tokens_equal": bool(torch.equal(out1, out2)),
               "accept_equal": bool(torch.equal(acc1, acc2)),
               "states_equal": equal, "max_state_diff": diff}
        rows.append(row)
        log(f"two-pass round {r}: accept {row['accept']} (two-pass "
            f"{acc2.tolist()}), tokens equal {row['tokens_equal']}, Mamba "
            f"conv and h states equal {equal} (largest difference {diff})")
        cand = torch.cat([cand[:, :1], out1[:, :-1]], dim=1)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"two-pass rounds' launches: {launches}")
    bad = [r for r in rows if not (r["tokens_equal"] and r["accept_equal"]
                                   and r["states_equal"])]
    if bad:
        raise AssertionError(f"two-pass step parts from the one-pass step: "
                             f"{bad}")
    n_attn = sum(m == "attn" for m, _ in cfg.layer_specs())
    if launches["decode_attention"] != 3 * n_attn * rounds:
        raise AssertionError(f"two-pass rounds not on decode_attention "
                             f"({n_attn} layers x 3 passes a round): "
                             f"{launches}")
    return {"rounds": rows, "launches": launches}


def serve_jamba(dev, tol, gen):
    """Phase 15 (a)-(e): the jamba cut (``jamba_cut``, bf16, random weights
    from seed 0) served in ``ServingEngine(batch=2, window_max=8,
    block_size=16, max_len=1024)`` with phase 14's prompts of 520, 600,
    700 and 300 tokens on paged_decode (one launch per attention layer per
    verify pass and prefill chunk) and spec_verify (one per verify round),
    one request on the gather fallback (paged_write), every request against
    the solo sampler on decode_attention and on the plain route under the
    margin rule, a split past the margin judged by the served routing
    (``RouteLog``); the two-pass step; the kernels at jamba's shapes; a
    profile split by layer kind and pass kind. Returns the report and the
    launches of the kernel path's run, the kernel-route solo sampler's and
    the fallback's."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import TransformerLM
    t0 = time.perf_counter()
    out = {"kernels": check_jamba_kernels(dev, gen)}
    cfg = jamba_cut()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_attn = sum(m == "attn" for m, _ in cfg.layer_specs())
    out.update(layers=[list(sp) for sp in cfg.layer_specs()],
               params_b=count_params(params) / 1e9,
               param_gb=torch.cuda.memory_allocated() / 1e9,
               weights=layer_bytes(cfg, params))
    log(f"{cfg.name} cut to {cfg.n_layers} layers {cfg.layer_specs()}: "
        f"d_model {cfg.d_model} (Mamba d_inner {2 * cfg.d_model}, "
        f"{cfg.ssm_state} states), {cfg.n_heads} heads / {cfg.n_kv_heads} kv "
        f"of {cfg.head_dim}, {cfg.n_experts} experts top {cfg.top_k}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: "
        f"{out['params_b']:.4f} B params counted ({out['param_gb']:.2f} GB), "
        f"init {time.perf_counter() - t0:.1f} s; weights read per pass by "
        f"layer kind: {out['weights']}")
    kw = dict(max_len=DENSE_MAX_LEN)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4), **kw)   # warm-up
    reqs = make_requests(cfg, DENSE_PROMPT_LENS, NEW_TOKENS)
    with RouteLog() as routes:
        done, m, wall, launches = serve(cfg, params, dev, reqs, **kw)
    tok = m["tokens_generated"]
    passes = m["verify_passes"] + m["prefill_calls"]
    log(f"serve {cfg.name} {cfg.n_layers}L: {len(done)} requests (prompts "
        f"{DENSE_PROMPT_LENS}), {tok} new tokens, {m['rounds']} verify "
        f"rounds ({m['rounds'] / tok:.4f} per token), {m['verify_passes']} "
        f"verify passes, {m['prefill_calls']} prefill chunks, "
        f"arm_calls_vs_ancestral {m['arm_calls_vs_ancestral']:.4f}, wall "
        f"{wall:.3f} s ({wall / tok * 1e3:.2f} ms per token, RouteLog on), "
        f"launches {launches}")
    if not (launches["paged_decode"] == n_attn * passes
            and launches["spec_verify"] == m["verify_passes"]
            and launches["paged_latent"] == 0
            and launches["rwkv_wkv"] == 0):
        raise AssertionError(
            f"{cfg.name}: paged_decode launched {launches['paged_decode']} "
            f"times (want {n_attn} x {passes} passes), spec_verify "
            f"{launches['spec_verify']} (want {m['verify_passes']}): "
            f"{launches}")
    out.update(metrics=m, wall_s=wall, launches=launches,
               ms_per_token=wall / tok * 1e3,
               rounds_per_token=m["rounds"] / tok)
    with LayerTap():
        out["profile"] = profile_serve(cfg, params, dev,
                                       DENSE_PROMPT_LENS[:2], DENSE_MAX_LEN)
    pr = out["profile"]
    split = {}
    for pkind, row in pr["ranges"].items():
        n = row["passes"]
        split[pkind] = {"passes": n, **{
            lk: {"device_ms_per_pass": v["device_us"] / 1e3 / n,
                 "launches_per_pass": v["launches"] / n,
                 "calls": v["calls"]}
            for lk, v in row.items() if lk != "passes"}}
        log(f"profile, {pkind} ({n}): " + "; ".join(
            f"{lk} {v['device_ms_per_pass']:.4g} device ms and "
            f"{v['launches_per_pass']:.1f} launches per pass"
            for lk, v in split[pkind].items() if lk != "passes"))
    out["layer_split"] = split
    out["weights_byte_bound_ms"] = sum(
        r["byte_bound_ms"] for r in out["weights"].values())
    log(f"weights read per pass: byte bound "
        f"{out['weights_byte_bound_ms']:.4g} ms (" + ", ".join(
            f"{k} x{r['layers']} {r['byte_bound_ms']:.4g} ms"
            for k, r in out["weights"].items()) + ")")
    torch.cuda.synchronize()
    reset_launches()
    log(f"solo agreement, {cfg.name} (margin rule, tolerance {tol}, solo on "
        f"decode_attention):")
    out["agreement_kernel_solo"] = solo_agreement(
        cfg, params, dev, done, tol, routes=routes,
        use_attention_kernel=True, **kw)
    solo_launches = dict(LAUNCHES)
    if solo_launches["decode_attention"] <= 0:
        raise AssertionError(f"solo sampler not on decode_attention: "
                             f"{solo_launches}")
    out["solo_launches"] = solo_launches
    log(f"solo agreement, {cfg.name} (margin rule, tolerance {tol}, plain "
        f"solo):")
    out["agreement_plain_solo"] = solo_agreement(cfg, params, dev, done, tol,
                                                 routes=routes, **kw)
    fb_reqs = make_requests(cfg, DENSE_PROMPT_LENS[3:], 8)
    with RouteLog() as fb_routes:
        fb_done, fm, fwall, fb_launches = serve(
            cfg, params, dev, fb_reqs, use_attention_kernel=False, **kw)
    log(f"serve {cfg.name} (gather fallback): {fm['tokens_generated']} new "
        f"tokens, {fm['rounds']} verify rounds, wall {fwall:.3f} s, "
        f"launches {fb_launches}")
    if fb_launches["paged_write"] <= 0 or fb_launches["paged_decode"] != 0:
        raise AssertionError(f"fallback path not taken: {fb_launches}")
    log(f"solo agreement, {cfg.name} gather fallback (plain solo):")
    out["fallback"] = {"metrics": fm, "wall_s": fwall,
                       "launches": fb_launches,
                       "agreement": solo_agreement(cfg, params, dev, fb_done,
                                                   tol, routes=fb_routes,
                                                   **kw)}
    out["two_pass"] = two_pass_check(cfg, params, dev)
    out["seconds"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    return out, launches, solo_launches, fb_launches


# ---------------------------------------------------------------------------
# Phase 16: the multimodal backbones, musicgen-large and internvl2-1b
# ---------------------------------------------------------------------------

FRONTEND_ARCHS = ("musicgen-large", "internvl2-1b")
SOLO_S = DENSE_MAX_LEN + 8     # the solo sampler's dense cache: max_len + W


def serve_frontend(dev, tol, arch):
    """Phase 16 (a): ``arch`` at its published widths (bf16, random weights
    from seed 0) served in ``ServingEngine(batch=2, window_max=8,
    block_size=16, max_len=1024)`` with phase 14's prompts on paged_decode
    (one launch per layer per verify pass and prefill chunk) and
    spec_verify (one per verify pass), both asserted; a profile of a
    shorter run (phase 3's prompts of 17 and 40 tokens, 16 new each: busy
    ms and idle share per pass); every request against
    the solo sampler on decode_attention, and one request served on the
    gather fallback (paged_write) against the plain solo sampler, under
    the margin rule. The reference serves tokens alone, so no prefix.
    Returns the report and the launches of the kernel path's run, the
    kernel-route solo sampler's and the fallback's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out = {"layers": cfg.n_layers, "G": cfg.n_heads // cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "vocab": cfg.vocab,
           "params_b": count_params(params) / 1e9,
           "param_gb": count_bytes(params) / 1e9, "laps_s": {}}

    def lap(name):
        out["laps_s"][name] = time.perf_counter() - t0
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, "
        f"{cfg.mlp_kind} d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied "
        f"{cfg.tie_embeddings}, {cfg.dtype}, {out['params_b']:.4f} B params "
        f"({out['param_gb']:.2f} GB), init {time.perf_counter() - t0:.1f} s")
    kw = dict(max_len=DENSE_MAX_LEN)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4), **kw)   # warm-up
    reqs = make_requests(cfg, DENSE_PROMPT_LENS, NEW_TOKENS)
    done, m, wall, launches = serve(cfg, params, dev, reqs, **kw)
    tok = m["tokens_generated"]
    passes = m["verify_passes"] + m["prefill_calls"]
    log(f"serve {cfg.name}: {len(done)} requests (prompts "
        f"{DENSE_PROMPT_LENS}), {tok} new tokens, {m['rounds']} verify "
        f"rounds ({m['rounds'] / tok:.4f} per token), {m['verify_passes']} "
        f"verify passes, {m['prefill_calls']} prefill chunks, "
        f"arm_calls_vs_ancestral {m['arm_calls_vs_ancestral']:.4f}, wall "
        f"{wall:.3f} s ({wall / tok * 1e3:.2f} ms per token), launches "
        f"{launches}")
    if not (launches["paged_decode"] == cfg.n_layers * passes
            and launches["spec_verify"] == m["verify_passes"]
            and launches["paged_latent"] == 0):
        raise AssertionError(
            f"{cfg.name}: paged_decode launched {launches['paged_decode']} "
            f"times (want {cfg.n_layers} x {passes} passes), spec_verify "
            f"{launches['spec_verify']} (want {m['verify_passes']}): "
            f"{launches}")
    out.update(metrics=m, wall_s=wall, launches=launches,
               ms_per_token=wall / tok * 1e3,
               rounds_per_token=m["rounds"] / tok)
    lap("serve")
    # phase 3's short prompts: passes of verify rounds more than of prefill
    # chunks, and a trace the profiler reads back in seconds
    out["profile"] = profile_serve(cfg, params, dev, PROMPT_LENS[:2],
                                   DENSE_MAX_LEN)
    lap("profile")
    pr = out["profile"]
    if pr["idle_share"] is not None:
        n = pr["rounds"] + pr["prefill_calls"]
        out["busy_ms_per_pass"] = pr["device_busy_s"] / n * 1e3
        out["wall_ms_per_pass"] = pr["wall_s"] / n * 1e3
    torch.cuda.synchronize()
    reset_launches()
    log(f"solo agreement, {cfg.name} (margin rule, tolerance {tol}, solo on "
        f"decode_attention):")
    out["agreement_kernel_solo"] = solo_agreement(
        cfg, params, dev, done, tol, use_attention_kernel=True, **kw)
    solo_launches = dict(LAUNCHES)
    if solo_launches["decode_attention"] <= 0:
        raise AssertionError(f"solo sampler not on decode_attention: "
                             f"{solo_launches}")
    out["solo_launches"] = solo_launches
    lap("solo")
    fb_reqs = make_requests(cfg, DENSE_PROMPT_LENS[3:], 8)
    fb_done, fm, fwall, fb_launches = serve(cfg, params, dev, fb_reqs,
                                            use_attention_kernel=False, **kw)
    log(f"serve {cfg.name} (gather fallback): {fm['tokens_generated']} new "
        f"tokens, {fm['rounds']} verify rounds, wall {fwall:.3f} s, "
        f"launches {fb_launches}")
    if fb_launches["paged_write"] <= 0 or fb_launches["paged_decode"] != 0:
        raise AssertionError(f"fallback path not taken: {fb_launches}")
    log(f"solo agreement, {cfg.name} gather fallback (plain solo):")
    out["fallback"] = {"metrics": fm, "wall_s": fwall,
                       "launches": fb_launches,
                       "agreement": solo_agreement(cfg, params, dev, fb_done,
                                                   tol, **kw)}
    lap("fallback")
    log(f"serve {cfg.name}: seconds to the end of each step {out['laps_s']}")
    del params
    torch.cuda.empty_cache()
    return out, launches, solo_launches, fb_launches


def train_frontend(dev, arch):
    """Phase 16 (b): ``arch`` at its published widths, 3 AdamW steps at
    B = 2, S = 2048 with the frontend's random prefix of 256 embeddings
    before the tokens (``random_prefix(fold_in(PRNGKey(0), step))``, as the
    train CLI draws it), so T = 2304 positions go through flash_attention
    at head width 64: one launch per layer per forward, each counted with
    its shape. The step-1 logits and per-position losses of the token
    positions on the kernel route are held against the plain route within
    ``ROUTE_LIMITS`` beside two planted faults the gate must catch (a kv
    head fault that the model's group size can show, and the dropped
    diagonal tile); the step-1 loss within 1e-2 of the plain route's, as
    phase 7. One more step under the profiler gives the busy share.
    Returns the report and the launches of the 3 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.core import random as jr
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_optimizer, make_train_step
    from repro_torch.models import frontends
    from repro_torch.models.losses import lm_loss
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config(arch)
    B, S, steps = 2, 2048, 3
    T = S + cfg.n_prefix_tokens
    t0 = time.perf_counter()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, steps=steps)
    state = opt.init(params)
    raw_step = make_train_step(cfg, opt, remat=False)
    pipe = TokenPipeline(token_batches(max(512, B * 8), B, S, cfg.vocab),
                         dev)
    batches = [next(pipe) for _ in range(steps + 1)]
    key = jr.prng_key(0, dev)
    prefixes = [frontends.random_prefix(jr.fold_in(key, it), cfg, B)
                for it in range(steps + 1)]
    fed = iter(prefixes)

    def step_fn(p, s, batch):
        return raw_step(p, s, batch, next(fed))
    out = {"B": B, "S": S, "T": T, "optimizer": "adamw",
           "n_prefix_tokens": cfg.n_prefix_tokens,
           "params_b": count_params(params) / 1e9,
           "prefix_std": float(prefixes[0].float().std())}
    faults = ("kv_head_next" if cfg.n_heads == cfg.n_kv_heads
              else "kv_head_mod", "diagonal_tile_dropped")
    with torch.no_grad():
        lp, _ = lm_loss(params, cfg, batches[0], prefixes[0],
                        use_kernel=False)
        out["route_diff"] = route_diffs(
            params, cfg, batches[0], attention, "flash_attention",
            {f: planted_fault(f) for f in faults}, prefix=prefixes[0])
    out["plain_loss_step1"] = float(lp)
    check_route_diffs(out["route_diff"], B * (S - 1), ROUTE_LIMITS)
    out["laps_s"] = {"route_gate": time.perf_counter() - t0}
    shapes, kernel_op = [], attention.flash_attention

    def counted(q, k, v, window=0):
        shapes.append((tuple(q.shape), tuple(k.shape), window))
        return kernel_op(q, k, v, window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    attention.flash_attention = counted
    try:
        params, state, rows = run_steps(cfg, step_fn, params, state,
                                        batches[:steps], cfg.name)
    finally:
        attention.flash_attention = kernel_op
    launches = dict(LAUNCHES)
    out.update(steps=rows, launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               flash_shapes=sorted({str(sh) for sh in shapes}))
    want = ((B, T, cfg.n_heads, cfg.head_dim),
            (B, T, cfg.n_kv_heads, cfg.head_dim), 0)
    log(f"train {cfg.name}: launches {launches}, flash calls "
        f"{len(shapes)} at {out['flash_shapes']}, peak memory "
        f"{out['peak_memory_gb']:.3f} GB")
    if (launches["flash_attention"] != cfg.n_layers * steps
            or set(shapes) != {want}):
        raise AssertionError(f"flash launches {launches['flash_attention']}"
                             f" at {set(shapes)}, want {cfg.n_layers} x "
                             f"{steps} at {want}")
    loss1 = rows[0]["loss"]
    diff = abs(loss1 - out["plain_loss_step1"])
    log(f"step-1 loss: kernel path {loss1:.9g}, plain path "
        f"{out['plain_loss_step1']:.9g}, |diff| {diff:.3g} (tolerance "
        f"1e-2, as phase 7); ln V {math.log(cfg.vocab):.4f}")
    if not diff <= 1e-2 or abs(loss1 - math.log(cfg.vocab)) > 1.0:
        raise AssertionError(f"step-1 loss: kernel {loss1} vs plain "
                             f"{out['plain_loss_step1']}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, prow = run_steps(cfg, step_fn, params, state,
                                        batches[steps:], "profiled")
    kern = kernel_times(prof)
    busy_ms = sum(k[0] for k in kern) / 1e3
    step_ms = sum(r["ms"] for r in rows[1:]) / (steps - 1)
    flash = [(us, n) for us, n, key in kern if "flash_attention_" in key]
    out["profile"] = {
        "step_ms_unprofiled": step_ms, "step_ms_profiled": prow[0]["ms"],
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / step_ms if kern else None,
        "flash_attention_ms": sum(f[0] for f in flash) / 1e3,
        "flash_attention_launches": sum(f[1] for f in flash),
        "positions_per_s": B * T / step_ms * 1e3,
        "top_kernels": [{"ms": us / 1e3, "count": n, "name": name[:90]}
                        for us, n, name in kern[:8]]}
    pr = out["profile"]
    if not kern:
        log("profile: the profiler recorded no device time")
    else:
        log(f"profile of one {cfg.name} train step: device busy "
            f"{busy_ms:.2f} ms of {step_ms:.2f} ms unprofiled; busy share "
            f"{pr['busy_share']:.4f}; flash_attention "
            f"{pr['flash_attention_ms']:.3f} ms over "
            f"{pr['flash_attention_launches']} launches; "
            f"{pr['positions_per_s']:.0f} positions/s")
        for k in pr["top_kernels"]:
            log(f"  {k['ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    out["laps_s"]["steps_and_profile"] = time.perf_counter() - t0
    log(f"train {cfg.name}: seconds to the end of each step "
        f"{out['laps_s']}")
    del params, state
    torch.cuda.empty_cache()
    return out, launches


def check_flash_float32(dev, gen, cases):
    """The flash kernel's float32 (CUDA-core) path against its plain
    version, both in float32: 1e-5, as the card's tests hold it (the
    two sum in another order)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rows = {}
    for name, B, T, window, H, KVH, hd in cases:
        q = torch.randn((B, T, H, hd), generator=gen, device=dev)
        k = torch.randn((B, T, KVH, hd), generator=gen, device=dev)
        v = torch.randn((B, T, KVH, hd), generator=gen, device=dev)
        got, lse = flash_attention_fwd(q, k, v, window)
        want, lse_want = flash_attention_ref(q, k, v, window)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        lse_err = float((lse - lse_want).abs().max())
        if not (bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
                and lse_err <= 1e-4):
            raise AssertionError(f"flash_attention float32 {name}: max err "
                                 f"o {err}, lse {lse_err}")
        vis = sum(min(i + 1, window) if window else i + 1 for i in range(T))
        b_ms, b_by = bound((q.numel() + k.numel() + v.numel()
                            + got.numel()) * 4 + lse.numel() * 4,
                           4 * hd * B * H * vis, "float32")
        rows[name] = {"max_abs_err": err, "lse_max_abs_err": lse_err,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "ms": device_ms(lambda: flash_attention_fwd(
                          q, k, v, window), iters=5, reps=2)}
        log(f"flash_attention float32 {name} B={B} T={T} H={H} KV={KVH} "
            f"d={hd}: {rows[name]}")
    return rows


def check_frontend_kernels(dev, gen):
    """Phase 16 (c): the kernels at the frontends' shapes (head width 64)
    against their plain versions, with device times, bounds and library
    times: flash_attention at both archs' training shapes (T = 2304: 2048
    tokens after the 256-token prefix; bf16, and float32 against the plain
    version in float32); paged_decode at the verify shape and the 64-wide
    prefill chunk and decode_attention at the solo sampler's, at
    musicgen-large's G = 1 (32 heads over 32) and internvl2-1b's G = 7
    (14 over 2); paged_write at their K/V rows of 4096 and 256 bytes;
    spec_verify over vocabularies of 2,048 and 151,655 (odd: its scalar
    branch)."""
    T, hd, nb = 2048 + 256, 64, DENSE_NB
    out = {}
    out["flash_attention"], _ = check_flash_attention(dev, gen, (
        ("musicgen_train", 2, T, 0, 32, 32, hd),
        ("internvl_train", 2, T, 0, 14, 2, hd)), backward=False)
    out["flash_attention_float32"] = check_flash_float32(dev, gen, (
        ("musicgen_train", 2, T, 0, 32, 32, hd),
        ("internvl_train", 2, T, 0, 14, 2, hd)))
    out["decode_attention"], _ = check_decode_attention(dev, gen, (
        ("musicgen_verify", 2, 8, SOLO_S, [700, 520], 0, 1, 32, hd),
        ("internvl_verify", 2, 8, SOLO_S, [700, 520], 0, 7, 2, hd)))
    out["paged_decode"], _ = check_paged_decode(dev, gen, (
        ("musicgen_verify", 2, 8, [700, 520], 0, 1, nb, 32, hd),
        ("musicgen_prefill", 1, 64, [600], 0, 1, nb, 32, hd),
        ("internvl_verify", 2, 8, [700, 520], 0, 7, nb, 2, hd),
        ("internvl_prefill", 1, 64, [600], 0, 7, nb, 2, hd)))
    out["paged_write"] = check_paged_write(dev, gen, (
        ("musicgen_verify", (2, 8, [700, 520], [1, 1]), (32, hd), nb),
        ("internvl_verify", (2, 8, [700, 520], [1, 1]), (2, hd), nb)))
    out["spec_verify"] = check_spec_verify(dev, gen, ((16, 2048),
                                                      (16, 151655)))
    return out


def frontends_phase(dev, tol, gen):
    """Phase 16: the kernels at the frontends' shapes, then each arch
    served and trained, the model freed before the next."""
    t0 = time.perf_counter()
    out = {"kernels": check_frontend_kernels(dev, gen)}
    log(f"phase 16 (c) took {time.perf_counter() - t0:.1f} s")
    for arch in FRONTEND_ARCHS:
        (out["serve_" + arch], *out["serve_launches_" + arch]) = \
            serve_frontend(dev, tol, arch)
        out["train_" + arch], out["train_launches_" + arch] = \
            train_frontend(dev, arch)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 16 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 17: per-request fault isolation on the qwen3-1.7b engine
# ---------------------------------------------------------------------------

def serve_faults(cfg, params, dev, reqs, cancel_after_sync=None, **kw):
    """``serve``'s engine run under a fault plan or a cancel: with
    ``cancel_after_sync`` the engine takes one step (one host sync) and
    that request, then running, is cancelled. Returns the done requests by
    uid, the metrics, the wall time and the launches."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, batch=2, window_max=8, block_size=16,
                        max_len=256, eps_key=1, use_verify_kernel=True,
                        device=dev, **kw)
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.uid} rejected: {r.error}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    if cancel_after_sync is not None:
        eng.step()
        if not any(s is not None and s.uid == cancel_after_sync
                   for s in eng.slots):
            raise AssertionError(f"request {cancel_after_sync} is not "
                                 "running after the first sync")
        if not eng.cancel(cancel_after_sync):
            raise AssertionError(f"cancel({cancel_after_sync}) failed")
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if launches["spec_verify"] <= 0 or launches["paged_decode"] <= 0:
        raise AssertionError(f"kernel path not taken: {launches}")
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests ended")
    return {r.uid: r for r in done}, eng.export_metrics(), wall, launches


def fault_phase(dev, tol, phase3):
    """Phase 17 on phase 3's qwen3-1.7b engine (full width, bf16, the same
    seed) and its 4 requests: an unfaulted run as phase 3's (adaptive W),
    its tokens bitwise phase 3's and its ms per token beside phase 3's,
    and the device time of the poison select a verify round makes while
    some slot holds a poisoned stream (none without one); then, at a fixed W = 8 so that a row's every
    product has the same shape whoever shares its batch, (a) request 1's
    stream poisoned with one retry: it is quarantined as ``nonfinite`` and
    retried on a fresh stream, its tokens bitwise a fault-free run of it
    on that stream and held against the solo sampler there under the
    margin rule, the other three bitwise the fault-free run's; (b) the
    first block allocation failed (``alloc=@0``), one admission fails and
    its retry's tokens equal the fault-free run's bitwise; (c) request 0
    cancelled after the first sync: the survivors equal the fault-free
    run's bitwise. Every run launches spec_verify and paged_decode."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.engine import fresh_stream_id
    from repro_torch.serving.faults import FaultPlan
    t0 = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    params = TransformerLM.init(cfg, seed=0, device=dev)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))      # warm-up
    out = {}

    def reqs():
        return make_requests(cfg, PROMPT_LENS, NEW_TOKENS)

    def equal(got, want, uids, label):
        for u in uids:
            if not (got[u].ok and np.array_equal(got[u].result, want[u])):
                raise AssertionError(f"{label}: request {u} differs from "
                                     f"the fault-free run: {got[u].error}")

    # the unfaulted run, as phase 3's
    done, m, wall, launches = serve_faults(cfg, params, dev, reqs(),
                                           faults=FaultPlan())
    base3 = {r.uid: r.result for r in phase3["done"]}
    equal(done, base3, range(4), "no plan vs phase 3")
    tok = m["tokens_generated"]
    out["no_plan"] = {"ms_per_token": wall / tok * 1e3, "launches": launches,
                      "phase3_ms_per_token": phase3["ms_per_token"],
                      "equal_to_phase3": True}
    # the poison select on the logits of a verify round (B = 2, W = 8),
    # made while some slot holds a poisoned stream
    logits = torch.randn((2, 8, cfg.vocab), device=dev)
    pz = torch.tensor([0, 1], device=dev)
    out["no_plan"]["poison_select_ms"] = device_ms(
        lambda: torch.where((pz > 0)[:, None, None],
                            torch.full_like(logits, float("nan")), logits))
    log(f"phase 17, no plan: {out['no_plan']['ms_per_token']:.3f} ms per "
        f"token (phase 3: {phase3['ms_per_token']:.3f}), tokens bitwise "
        f"phase 3's; the poison select, made while a slot holds a "
        f"poisoned stream, {out['no_plan']['poison_select_ms'] * 1e3:.3f} "
        f"device us per verify round; launches {launches}")

    fixed = dict(adaptive=False)
    base, _, _, _ = serve_faults(cfg, params, dev, reqs(),
                                 faults=FaultPlan(), **fixed)
    base = {u: r.result for u, r in base.items()}
    # (a) a poisoned stream, quarantined and retried on a fresh one
    got, m, wall, launches = serve_faults(
        cfg, params, dev, reqs(), faults=FaultPlan(poison_streams=(1,)),
        request_retries=1, **fixed)
    r1 = got[1]
    fresh = fresh_stream_id(1, frozenset({1}))
    if not (r1.ok and r1.retries == 1 and r1.seq_id == fresh
            and m["retries"] == 1 and m["requests_failed"] == 0):
        raise AssertionError(f"poisoned request 1 not retried on stream "
                             f"{fresh}: {r1.error}, retries {r1.retries}, "
                             f"{m}")
    equal(got, base, (0, 2, 3), "poison")
    alone, _, _, _ = serve_faults(
        cfg, params, dev, [Request(uid=1, prompt=r1.prompt,
                                   new_tokens=r1.new_tokens,
                                   noise_seed=fresh)],
        faults=FaultPlan(), **fixed)
    if not np.array_equal(alone[1].result, r1.result):
        raise AssertionError("the retried request differs from a "
                             "fault-free run on its fresh stream")
    log(f"phase 17 (a), request 1 poisoned: quarantined, retried on stream "
        f"{fresh}, equal to a fault-free run there bitwise, the others "
        f"bitwise the fault-free run's; launches {launches}; solo "
        f"agreement on that stream (margin rule, tolerance {tol}, solo on "
        f"decode_attention):")
    out["poison"] = {"fresh_stream": fresh, "metrics": m,
                     "launches": launches,
                     "solo": solo_agreement(cfg, params, dev, [r1], tol,
                                            use_attention_kernel=True)}
    out["poison"]["solo_bitwise"] = out["poison"]["solo"][0]["equal"]
    # (b) an allocation fault at the first admission
    got, m, wall, launches = serve_faults(
        cfg, params, dev, reqs(),
        faults=FaultPlan(schedule={"alloc": (0,)}), request_retries=1,
        **fixed)
    if not (m["faults_fired_alloc"] == 1 and m["retries"] == 1
            and got[0].retries == 1):
        raise AssertionError(f"alloc fault: {m}")
    equal(got, base, range(4), "alloc fault")
    out["alloc"] = {"metrics": m, "launches": launches}
    log(f"phase 17 (b), alloc=@0: request 0's admission failed, retried, "
        f"all 4 bitwise the fault-free run's; launches {launches}")
    # (c) a running request cancelled after the first sync
    got, m, wall, launches = serve_faults(cfg, params, dev, reqs(),
                                          cancel_after_sync=0, **fixed)
    if not (got[0].error is not None and got[0].error.code == "cancelled"
            and m["requests_cancelled"] == 1):
        raise AssertionError(f"cancel: {got[0].error}, {m}")
    equal(got, base, (1, 2, 3), "cancel")
    out["cancel"] = {"metrics": m, "launches": launches}
    log(f"phase 17 (c), request 0 cancelled after the first sync: the "
        f"other 3 bitwise the fault-free run's; launches {launches}")
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17 took {out['seconds']:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None,
                    help="write every number measured to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.engine.spec_decode import make_eps_fn
    from repro_torch.models.transformer import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN runs only plain convolutions of phases 11-12 (the autoencoder's,
    # the forecasts' 1x1 output layers), whose default backward algorithms
    # are not deterministic: a training would end elsewhere from run to run
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    report = {"gpu": smi}

    # ---- phase 2: build, then each kernel against its plain version ------
    t0 = time.perf_counter()
    lib = kernels.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"built {lib.relative_to(ROOT)} in {report['build_s']:.1f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    report["ptxas"] = ptxas_lines(lib.parent / "build.log")
    log("ptxas, flash_attention, decode_attention, paged_decode, "
        "paged_write, paged_latent and rwkv_wkv:")
    for line in report["ptxas"]:
        log("  " + line)
    report["sass"] = sass_counts(lib)
    if report["sass"] is None:
        log("SASS of flash_attention: not available (no cuobjdump)")
    for fn, n in (report["sass"] or {}).items():
        log(f"SASS of {fn}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA")
    gen = torch.Generator(device=dev).manual_seed(0)
    sv = check_spec_verify(dev, gen)
    pd, pd_err = check_paged_decode(dev, gen)
    pw = check_paged_write(dev, gen)
    pl, pl_err = check_paged_latent(dev, gen)
    fa, fa_err = check_flash_attention(dev, gen)
    rw, rw_err = check_rwkv_wkv(dev, gen)
    da, da_err = check_decode_attention(dev, gen)
    report["kernels_detail"] = {"spec_verify": sv, "paged_decode": pd,
                                "paged_write": pw, "paged_latent": pl,
                                "flash_attention": fa, "rwkv_wkv": rw,
                                "decode_attention": da}

    eps_fn = make_eps_fn(1, V)
    sid = torch.tensor([0, 1], device=dev)
    pos = torch.arange(8, device=dev)[None] + torch.tensor([[40], [90]],
                                                           device=dev)
    report["eps_ms_B2_W8"] = device_ms(lambda: eps_fn(sid, pos), iters=5)
    log(f"eps generation (B=2, W=8, V={V}): "
        f"{report['eps_ms_B2_W8']:.4f} device ms per round")

    # ---- phase 3: the full-width serving run on the kernel path ----------
    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    params = TransformerLM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {cfg.dtype}, {n_params / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s")
    # warm-up (cuBLAS handles, first launches) so the timed run is warm
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))
    reqs = make_requests(cfg, PROMPT_LENS, NEW_TOKENS)
    done, m, wall, launches = serve(cfg, params, dev, reqs)
    log(f"serve (fused kernel path): {len(done)} requests, "
        f"{m['tokens_generated']} new tokens, {m['rounds']} verify rounds, "
        f"{m['prefill_calls']} prefill chunks, arm_calls_vs_ancestral "
        f"{m['arm_calls_vs_ancestral']:.4f}, {m['host_syncs']} host syncs, "
        f"wall {wall:.3f} s ({wall / m['tokens_generated'] * 1e3:.2f} ms "
        f"per token), launches {launches}")
    if launches["spec_verify"] <= 0 or launches["paged_decode"] <= 0:
        raise AssertionError(f"kernel path not taken: {launches}")
    passes = m["verify_passes"] + m["prefill_calls"]
    if launches["paged_decode"] != cfg.n_layers * passes:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times, not "
            f"once per layer per pass ({cfg.n_layers} x {passes})")
    report["serve"] = {"metrics": m, "wall_s": wall, "launches": launches}
    phase3 = {"done": done, "ms_per_token": wall / m["tokens_generated"] * 1e3}
    report["profile"] = profile_serve(cfg, params, dev)

    # ---- phase 4: the gather fallback, the writeback kernel's path -------
    fb_reqs = make_requests(cfg, PROMPT_LENS[:2], 8)
    fb_done, fm, fwall, fb_launches = serve(cfg, params, dev, fb_reqs,
                                            use_attention_kernel=False)
    log(f"serve (gather fallback): {len(fb_done)} requests, "
        f"{fm['tokens_generated']} new tokens, {fm['rounds']} verify rounds, "
        f"wall {fwall:.3f} s, launches {fb_launches}")
    if fb_launches["paged_write"] <= 0 or fb_launches["paged_decode"] != 0:
        raise AssertionError(f"fallback path not taken: {fb_launches}")
    report["serve_fallback"] = {"metrics": fm, "wall_s": fwall,
                                "launches": fb_launches}

    # ---- phase 5: agreement with the solo sampler ------------------------
    # bf16 logits of magnitude ~1 after 28 layers; the fused kernel keeps
    # scores in float32 where the solo path's _sdpa rounds them to bf16, so
    # the two logit vectors differ by up to a few hundredths
    tol = 0.25
    log(f"solo agreement (margin rule, tolerance {tol}):")
    report["agreement"] = solo_agreement(cfg, params, dev, done, tol)
    del params
    torch.cuda.empty_cache()

    # ---- phase 6: DeepSeek-V3's MLA layers at full width ------------------
    report["deepseek"], ds_launches = serve_deepseek(dev, tol)

    # ---- phase 7: training qwen3-1.7b on the flash-attention kernel ------
    report["train"], tr_launches = train_qwen(dev)

    # ---- phase 8: the forecast-KL objective on DeepSeek-V3 ---------------
    report["train_deepseek"] = train_deepseek(dev, tol)

    # ---- phase 9: rwkv6-7b served at full width on the WKV kernel --------
    report["rwkv"], rw_launches = serve_rwkv(dev, get_config("rwkv6-7b"),
                                             tol)

    # ---- phase 10: the solo sampler's dense cache on its kernel ----------
    report["solo_dense"], sd_launches = solo_dense(dev, cfg, done, tol)

    # ---- phases 11-12: the samplers of Tables 1 and 2 at full width -----
    report["table1"] = table1(dev)
    report["table2"] = table2(dev)

    # ---- phase 13: the MoE layer, DeepSeek-V3 and dbrx-132b --------------
    t13 = time.perf_counter()
    report["moe_deepseek"], _ = serve_moe(dev, tol, "deepseek-v3-671b", 4,
                                          latent=True)
    report["moe_dbrx"], dbrx_launches = serve_moe(dev, tol, "dbrx-132b", 4,
                                                  latent=False)
    report["train_dbrx"], dbrx_train_launches = train_dbrx(dev)
    report["phase13_s"] = time.perf_counter() - t13
    log(f"phase 13 took {report['phase13_s']:.1f} s")
    dbrx_solo = report["moe_dbrx"]["fpi"]["solo_launches"]

    # ---- phase 14: gemma3-1b, gemma-2b, a mistral-large-123b cut ---------
    t14 = time.perf_counter()
    dense = check_dense_kernels(dev, gen)
    report["dense_kernels"] = dense
    served = {}
    for key, arch, n_layers in (("gemma3", "gemma3-1b", None),
                                ("gemma2b", "gemma-2b", None),
                                ("mistral", "mistral-large-123b", 8)):
        report["serve_" + key], *served[key] = serve_dense(dev, tol, arch,
                                                          n_layers)
    report["train_gemma3"], g3_train = train_gemma3(dev)
    report["phase14_s"] = time.perf_counter() - t14
    log(f"phase 14 took {report['phase14_s']:.1f} s")

    # ---- phase 15: the Mamba mixer, a jamba-1.5-large-398b cut ----------
    report["serve_jamba"], *served["jamba"] = serve_jamba(dev, tol, gen)
    log(f"phase 15 took {report['serve_jamba']['seconds']:.1f} s")

    # ---- phase 16: the multimodal backbones at head width 64 ------------
    report["frontends"] = frontends_phase(dev, tol, gen)

    # ---- phase 17: fault isolation on phase 3's engine --------------------
    report["faults"] = fault_phase(dev, tol, phase3)

    entries = []
    for name, rows, key, n, path, extra in (
            ("spec_verify", sv, f"R16_V{V}", launches["spec_verify"],
             "serve", 0),
            ("paged_decode", pd, "verify", launches["paged_decode"], "serve",
             pd_err),
            ("paged_write", pw, "verify", fb_launches["paged_write"],
             "serve_gather_fallback", 0),
            ("paged_latent", pl, "verify", ds_launches["paged_latent"],
             "serve_deepseek", pl_err),
            ("flash_attention", {k: v for k, v in fa.items()
                                 if k != "backward_T512"}, "qwen_train",
             tr_launches["flash_attention"], "train", fa_err["o"]),
            ("rwkv_wkv", rw, "verify", rw_launches["rwkv_wkv"],
             "serve_rwkv", rw_err),
            ("decode_attention", da, "verify",
             sd_launches["decode_attention"], "solo_dense", da_err)):
        row = rows[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": {
                "spec_verify": "src/repro/kernels/spec_verify/kernel.py:53",
                "paged_decode":
                    "src/repro/kernels/paged_attention/kernel.py:192",
                "paged_write":
                    "src/repro/kernels/paged_attention/kernel.py:320",
                "paged_latent":
                    "src/repro/kernels/paged_attention/kernel.py:248",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:68",
                "rwkv_wkv": "src/repro/kernels/rwkv_wkv/kernel.py:49",
                "decode_attention":
                    "src/repro/kernels/decode_attention/kernel.py:79"}[name],
            "launches": n, "path": path,
            "max_abs_err": max(float(r["max_abs_err"]) for r in rows.values())
            if extra == 0 else extra,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "eager_ms": row["eager_ms"], "eager_plain_ms": row["eager_plain_ms"],
            "eager_library_ms": row["eager_library_ms"]})
    # the other shapes of the path's kernels, beside their main row; dbrx-
    # 132b's (G = 6) with the launches of phase 13's paths
    for name, rows, keys in (
            ("paged_decode", pd, ("prefill", "dbrx_verify", "dbrx_S2048")),
            ("paged_latent", pl, ("prefill", "decode")),
            ("rwkv_wkv", rw, ("prefill", "zero_state_T1024")),
            ("decode_attention", da, ("dbrx_verify", "dbrx_S2048")),
            ("flash_attention", fa, ("dbrx_train",))):
        entry = next(e for e in entries if e["name"] == name)
        for key in keys:
            entry[key] = {k: rows[key][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err")}
    for name, key, n, path in (
            ("paged_decode", "dbrx_verify", dbrx_launches["paged_decode"],
             "serve_moe_dbrx"),
            ("decode_attention", "dbrx_verify",
             dbrx_solo["decode_attention"], "solo_moe_dbrx"),
            ("flash_attention", "dbrx_train",
             dbrx_train_launches["flash_attention"], "train_dbrx")):
        entry = next(e for e in entries if e["name"] == name)
        entry[key].update(launches=n, path=path)
    # phase 14's shapes (head width 256, G = 4, 8 and 12, the gemma and
    # mistral vocabularies), each with the launches of the path that runs
    # it; a prefill row's launches are counted in its verify row's
    by_window = report["train_gemma3"]["calls_by_window"]
    jk = report["serve_jamba"]["kernels"]
    for name, key, n, path in (
            ("flash_attention", "gemma3_local", by_window.get(512, 0),
             "train_gemma3 (window 512)"),
            ("flash_attention", "gemma3_global", by_window.get(0, 0),
             "train_gemma3 (global layers)"),
            ("flash_attention", "gemma2b_train", 0, None),
            ("decode_attention", "gemma3_verify",
             served["gemma3"][1]["decode_attention"], "solo_gemma3"),
            ("decode_attention", "gemma3_prefill", None, "solo_gemma3"),
            ("decode_attention", "gemma2b_verify",
             served["gemma2b"][1]["decode_attention"], "solo_gemma2b"),
            ("paged_decode", "gemma3_verify",
             served["gemma3"][0]["paged_decode"], "serve_gemma3"),
            ("paged_decode", "gemma3_prefill", None, "serve_gemma3"),
            ("paged_decode", "gemma2b_verify",
             served["gemma2b"][0]["paged_decode"], "serve_gemma2b"),
            ("paged_decode", "mistral_verify",
             served["mistral"][0]["paged_decode"], "serve_mistral"),
            ("paged_write", "gemma_verify",
             served["gemma3"][2]["paged_write"], "serve_gemma3_fallback"),
            ("paged_write", "gemma_prefill", None, "serve_gemma3_fallback"),
            ("spec_verify", "R16_V262144",
             served["gemma3"][0]["spec_verify"], "serve_gemma3"),
            ("spec_verify", "R16_V256000",
             served["gemma2b"][0]["spec_verify"], "serve_gemma2b"),
            ("spec_verify", "R16_V32768",
             served["mistral"][0]["spec_verify"], "serve_mistral"),
            # phase 15's shapes (jamba: G = 8, vocab 65,536)
            ("paged_decode", "jamba_verify",
             served["jamba"][0]["paged_decode"], "serve_jamba"),
            ("paged_decode", "jamba_prefill", None, "serve_jamba"),
            ("decode_attention", "jamba_verify",
             served["jamba"][1]["decode_attention"], "solo_jamba"),
            ("spec_verify", "R16_V65536",
             served["jamba"][0]["spec_verify"], "serve_jamba")):
        entry = next(e for e in entries if e["name"] == name)
        row = (jk if key.startswith(("jamba", "R16_V65536")) else
               dense)[name][key]
        entry[key] = {k: row[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}
        entry[key].update(launches=n, path=path)
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   float(row["max_abs_err"]))
    # phase 16's shapes (head width 64: musicgen-large's G = 1, internvl2-
    # 1b's G = 7, their vocabularies), each with the launches of its path
    fr = report["frontends"]
    fk = fr["kernels"]
    for name, key, n, path in (
            ("flash_attention", "musicgen_train",
             fr["train_launches_musicgen-large"]["flash_attention"],
             "train_musicgen"),
            ("flash_attention", "internvl_train",
             fr["train_launches_internvl2-1b"]["flash_attention"],
             "train_internvl"),
            ("decode_attention", "musicgen_verify",
             fr["serve_launches_musicgen-large"][1]["decode_attention"],
             "solo_musicgen"),
            ("decode_attention", "internvl_verify",
             fr["serve_launches_internvl2-1b"][1]["decode_attention"],
             "solo_internvl"),
            ("paged_decode", "musicgen_verify",
             fr["serve_launches_musicgen-large"][0]["paged_decode"],
             "serve_musicgen"),
            ("paged_decode", "musicgen_prefill", None, "serve_musicgen"),
            ("paged_decode", "internvl_verify",
             fr["serve_launches_internvl2-1b"][0]["paged_decode"],
             "serve_internvl"),
            ("paged_decode", "internvl_prefill", None, "serve_internvl"),
            ("paged_write", "musicgen_verify",
             fr["serve_launches_musicgen-large"][2]["paged_write"],
             "serve_musicgen_fallback"),
            ("paged_write", "internvl_verify",
             fr["serve_launches_internvl2-1b"][2]["paged_write"],
             "serve_internvl_fallback"),
            ("spec_verify", "R16_V2048",
             fr["serve_launches_musicgen-large"][0]["spec_verify"],
             "serve_musicgen"),
            ("spec_verify", "R16_V151655",
             fr["serve_launches_internvl2-1b"][0]["spec_verify"],
             "serve_internvl")):
        entry = next(e for e in entries if e["name"] == name)
        row = fk[name][key]
        entry[key] = {k: row[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}
        entry[key].update(launches=n, path=path)
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   float(row["max_abs_err"]))
    report["kernels"] = entries
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1, default=str))
    log(f"gpu: {smi}")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
