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
9. rwkv6-7b at full width (bf16, random parameters from seed 0), served
   on its first 4 of 32 layers (``RWKV_SERVE_LAYERS``): phase 3's 4
   requests with every layer's WKV recurrence on the WKV kernel (4
   launches per verify pass, all in its verify form, and 4 per prefill
   chunk, all in its prefill form),
   a profile, every request against the solo sampler on the plain scan
   under the margin rule; ``TransformerLM.apply`` at T = 1024 on all 32
   layers, on the kernel route against the plain route, gated beside two
   planted faults;
   then (e) two requests at a fixed W = 8 with one forced
   ``preempt_slot`` after the first sync (the slot's float32 recurrent
   rows parked on the host and restored), tokens and verify rounds
   bitwise the run without it; (a)-(e) run without the host tier
   (``host_cache_mb=0``); (f) the host tier's recurrent snapshots at
   ``host_cache_mb=512``: two requests sharing a 64-token prefix served
   one after the other at ``prefill_chunk=16``, at least 4 state captures
   and 1 restore, fewer prefill chunks than without the tier, both
   requests' tokens bitwise the tier-less run's (the same 16-wide chunks)
   and under the margin rule against the solo sampler; then a forced park
   through the tier, bitwise the undisturbed run, its ms beside (e)'s
   pageable park;
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
   before the next (``MOE_SERVE_LAYERS``: 2 layers each since the model
   axis's phase 23 took their time): (a) DeepSeek-V3 cut to 1 dense-prefix
   layer plus 1 MoE layer (256 routed experts + 1 shared, top-8, sigmoid),
   phase 6's 4 requests served on the latent kernel's path
   with fixed-point forecasts and with the forecast heads, profiled, once
   on the gather fallback, every request against the plain solo sampler;
   (b) dbrx-132b cut to 2 (attn, moe) layers (16 experts, top-4,
   softmax), served on paged_decode (dbrx's 6 query heads per kv head) and
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
   freed before the next, cut in depth as ``DENSE_LAYERS`` says: (a)
   gemma3-1b cut to 8 of its 26 layers (one 5:1 block and the two
   trailing local layers: 7 ``local`` at a 512-key window, 1 global; one
   kv head of width 256; vocab 262,144), 4 requests with prompts of 520,
   600, 700 and 300 tokens (32 new each) in ``ServingEngine(batch=2,
   window_max=8, block_size=16, max_len=1024)`` on paged_decode (8
   launches per verify pass and prefill chunk, asserted), profiled, one
   request on the gather fallback (paged_write), every request against
   the solo sampler on decode_attention and on the plain route under the
   margin rule; (b) gemma-2b cut to 3 of its 18 layers (8 query heads
   over one kv head of 256, no window) the same; (c) mistral-large-123b
   cut to 2 of its 88 layers (96 query heads over 8 kv heads of 128,
   G = 12) the same; (d) gemma3-1b (all 26 layers) trained 3 AdamW steps at B = 2, S = 2048 on the flash kernel
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
   weights from seed 0; cut to 6 layers, ``FRONTEND_LAYERS``:
   musicgen-large of its 48, internvl2-1b of its 24), each freed before
   the next: (a)
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
18. the scheduler under saturation on phase 3's qwen3-1.7b at a fixed
   W = 8 (``drive``; each run's launches counted from 0, spec_verify and
   paged_decode or paged_write asserted): (a) two priority-5 requests
   (prompts 40 and 80, 96 new each), then after the first sync a
   priority-0 arrival (17, 32 new) that preempts one: at least one
   preemption and resume, the low-priority requests' tokens and verify
   rounds bitwise the run without the arrival, the arrival against the
   solo sampler under the margin rule; blocks and bytes parked, park and
   resume ms (host clock after ``synchronize``), ms per token of both
   runs; (b) 8 requests (phase 3's prompt lengths twice, 32 new each,
   ``rounds_per_sync=8``) unstaged and with ``staging_slots=2`` and the
   adaptive k: in-loop adoptions, fewer host syncs staged, every staged
   request against the solo sampler under the margin rule (the count
   bitwise logged), the staged engine left clean (nothing staged or
   claimed, rows the inactive lane, no block in use); ms per token, host
   syncs per token, verify passes, idle row-rounds and each run's idle
   share from a profiled repeat; (c) a parked and a staged request
   cancelled, the others bitwise the run without the cancels; (d) the
   legacy dense round (``paged_attention=False``) on two requests,
   2 x 28 paged_write launches per pass asserted, tokens against phase
   3's under the margin rule, ms per token. Phase 18 runs without the
   host tier (its parks go to pageable host memory).
19. the host cache tier on phase 3's qwen3-1.7b at a fixed W = 8 (each run
   through ``drive``, spec_verify and paged_decode asserted): (a) at batch
   1 over 10 usable blocks, request A (a 64-token prefix and 1 token, 32
   new), B (120 tokens, whose worst case takes the whole pool and evicts
   A's 4 prefix blocks, spilled D2H into the pinned arena) and C (the same
   prefix and another token, its 4 blocks restaged through the staging
   ring): at least 4 spilled and restaged, C's 4 prefix hits, fewer
   prefill chunks than the tier-less run (which drops the 4 blocks), every
   token bitwise the tier-less run's and against the solo sampler under
   the margin rule; spill ms and MB, restage ms and GB/s beside the
   tier-less prefill of the same positions, the overlap fraction, and the
   ring's own rate from pinned and pageable memory and the crc32's; (b) at
   batch 2, two priority-5 requests sharing a 40-token prompt (96 new)
   both preempted after the first sync by two priority-0 arrivals (17, 32
   new): the second park adds exactly one arena entry (the shared blocks
   are pinned, not copied), tokens and verify rounds bitwise the run
   without the arrivals, park and resume ms beside phase 18 (a)'s pageable
   ones; (c) ``arena_corrupt=@0`` on (b) (one resume recomputes, tokens
   bitwise) and ``stage_drop=@0`` on (a) (one staging error, tokens
   bitwise).
20. crash-safe serving on phase 3's qwen3-1.7b cut to its first 14
   layers (``DURABLE_LAYERS``) at a fixed W = 8, the
   durable directories temporary ones under ``build/`` (their filesystem
   type from ``/proc/mounts`` logged): (a) phase 19 (b)'s workload on an
   engine with ``durable_dir`` and ``journal_fsync_every=1`` against the
   volatile one: tokens and verify rounds bitwise, the journal records
   the schedule implies (4 submits, an admit per admission and resume, a
   park per preemption, 4 finishes), a checkpoint per host sync, the
   parks' 2 shared blocks flushed to disk; ms per token of both runs, ms
   per fsync and per checkpoint (mean, max), the journal's bytes; (b)
   phase 19 (a)'s traffic through a 2 MiB arena (two of the cut's
   0.9175 MB blocks) over the disk tier: A's prefix blocks go pool -> arena ->
   disk and C restages its 4 through disk and arena, at least 2 disk
   hits and promotions, fewer prefill chunks than the tier-less run,
   tokens bitwise its; disk put and get ms and MB/s a block, the restage
   ms beside the tier-less prefill of the same positions; (c) the script
   run again as a child on the card (``--recovery-child serve DIR``),
   which serves (a)'s workload printing a JSON event per submit and
   finish, killed by ``REPRO_KILL_POINT`` (in its environment only) at
   ``post_sync:1`` (after the checkpoint that holds the parks) and at
   ``mid_spill:0`` (in the first disk put), each death a SIGKILL; a
   child (``--recovery-child resume DIR``) restores and drains, and for
   ``post_sync`` a second one from a copy of the directory without the
   disk tier: every accepted request delivered by the two processes, a
   re-delivery equal to the first, at least one request recovered, a
   park restored after ``post_sync`` and the disk resume's prefixes hit
   on disk; requests admitted again from their prompt bitwise (a)'s
   volatile run, a restored park under the margin rule (its first split
   and margin logged); the ms to recover (the engine's construction and
   ``restore``, first), a second, warm pass of the replay and the
   checkpoint load, each child's seconds, prefill chunks with and
   without the disk.
21. the hot-path checks and the launch layer on phase 3's qwen3-1.7b
   engine and its 4 requests: (a) served with ``REPRO_CHECK_CONTRACTS=1``
   once through the round loop and once with ``staging_slots=2`` through
   the staged loop: every round and prefill region runs under
   ``set_sync_debug_mode("error")`` (a synchronizing call raises) and
   the first dispatch of each variant passes its contract under the op
   census (``repro_torch.analysis``); per checked loop its transient
   bytes, aten ops and kernel launches per verify pass, pool scatters and
   host reads, the label's argument signatures (at most 8), the pool
   leaves' addresses unchanged over the run; tokens and verify rounds
   bitwise the same run with the checks off; (b) the same workload with
   ``donate=False`` (``--no-donate``: the paged cache copied out of place
   at every dispatch) in turns with the in-place run (in-place, copy,
   copy, in-place): tokens bitwise, ms per token and peak memory of both;
   (c) the four torch examples (``examples/*_torch.py``) as subprocesses
   on the card, at once, each exiting 0 with its exactness line; exit
   codes and seconds.
22. the data-parallel mesh engine (``mesh_phase``): two shards of
   phase 18's qwen3-1.7b (its first ``MESH_LAYERS`` = 7 layers) on this
   card against one at batch 2 and 4, a cross-shard
   migration, a rebalancing admission.
23. the model axis (``model_axis_phases``, with phase 24 in one spawn of
   the ranks): two model ranks, processes of their own over gloo on this
   card, serve qwen3-1.7b at full width (its first ``TP_LAYERS`` = 14
   layers) on tensor-parallel parameters (window logits within the
   tolerance of model 1's, the collectives of a verify pass, tokens
   bitwise across the ranks and under the margin rule against model 1,
   ms per token and idle share of both), durably (rank 0's journal and
   checkpoints, each rank's disk tier; ms of an fsync and of a
   checkpoint), at data 2 x model 2 bitwise data 1 x model 2 at the same
   rows a call with a cross-shard migration, and the dbrx-132b cut
   expert-parallel (the MoE layer against the whole one, its time on
   each rank, served tokens against the solo sampler with the routing
   judged as in phase 13); (d) a fresh engine restores a copy of (a)'s
   directory taken mid-run and ends with (a)'s tokens bitwise (the
   restore's ms); (e) a deadline and ``max_request_seconds`` with rank
   1's clock skewed: the same decisions and tokens on both ranks.
24. the model axis for training (``train_mesh_before``,
   ``train_mesh_rank``, ``train_mesh_after``): qwen3-1.7b at
   full width cut to 14 layers, B = 2, S = 2048, bf16, AdamW,
   ``remat=True``, phase 7's seed-0 parameters and batches, first on one
   device (step 1's loss, global norm and four named gradients kept on
   the host; two steps timed), then on two ranks sharing this card over
   gloo, (a) at data 1 x model 2 and (b) at data 2 x model 1
   (``shard_train_step``): step 1's loss, norm and named gradients
   gathered whole within ``TRAIN_MESH_TOL`` of the single device's,
   which every planted fault (``TRAIN_FAULTS``: a copy_to backward left
   out, the data mean's all-reduce of the leaves not split over data
   left out, the FSDP sum left out, the norm counted per rank) exceeds,
   two steps timed (ms, tokens/s, peak memory, the
   collectives and bytes a step by axis, flash launches: 2 x layers a
   step, the forward and the recompute), the replicated leaves bitwise
   across the ranks after each, the logits gather timed alone; (c) the
   dbrx-132b cut's MoE layer at data 1 x model 2 (8 experts a rank), a
   forward and backward at capacity 1.25 and an Adafactor step against
   the whole layer's within ``MOE_TRAIN_TOL``.

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
three phase 15's and five phase 16's, with the launches of their paths;
the model-axis paths' launches a rank, phase 23's and phase 24's);
the last line is ``{"ok": true, "device": {...}}``. ``--report PATH``
also writes every number measured to PATH as JSON, the seconds of each
phase among them (``phase_seconds``), phase 20's under ``durable``.
``--recovery-child {serve,resume} DIR [--no-disk-tier]`` runs phase 20
(c)'s child instead of the phases.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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


def profile_serve(cfg, params, dev, lens=PROMPT_LENS[:2], max_len=256,
                  **kw):
    """Where the time of a short serving run on the kernel path goes (2
    requests of prompts ``lens``, 16 new tokens each): the run once without
    the profiler for its wall time, then once under ``torch.profiler`` for
    the device busy time from its kernel records and the kernels that take
    the most. The idle share is taken against the unprofiled wall, since
    the profiler lengthens the host's time but not the kernels'. ``kw``
    goes to the engine."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = make_requests(cfg, lens, 16)
    _, m, wall, _ = serve(cfg, params, dev, reqs, max_len=max_len, **kw)
    reqs = make_requests(cfg, lens, 16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pm, pwall, _ = serve(cfg, params, dev, reqs, max_len=max_len,
                                **kw)
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
# rwkv6-7b's depth cut for phase 9's serving, solo, preemption and snapshot
# runs (of its 32 layers, at every published width): 4 since phase 23 was
# added, 8 since phase 22's mesh runs were timed beside a batch-2 engine,
# 32 before; the route gates above run all 32
RWKV_SERVE_LAYERS = 4


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
    """Phase 9: rwkv6-7b at full width (random weights from seed 0), served
    on its first ``RWKV_SERVE_LAYERS`` layers on the WKV kernel's path (a
    launch per layer per verify pass and prefill chunk), profiled, every
    request held against the solo sampler on the WKV kernel and on the
    plain scan, a forced preemption and the host tier's snapshots; then
    ``TransformerLM.apply`` on all its layers at B = 1, T = ``route_T`` on
    the kernel route against the plain scan and against the op's plain
    version, each gated beside two planted faults (``RWKV_ROUTE_LIMITS``
    were set at that depth). Returns the phase's report and the serving
    run's launches."""
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
    full_cfg, full_params = cfg, params
    cfg = dataclasses.replace(cfg, n_layers=RWKV_SERVE_LAYERS)
    params = dict(params, layers=params["layers"][:RWKV_SERVE_LAYERS])
    out["serve_layers"] = cfg.n_layers
    out["serve_params"] = count_params(params)
    log(f"served on its first {cfg.n_layers} layers, "
        f"{out['serve_params'] / 1e9:.3f} B params")
    # (a)-(e) without the host tier, whose snapshots would cut prefill at
    # block boundaries: their passes and times stay comparable with earlier
    # runs; (f) runs the tier
    tierless = dict(host_cache_mb=0)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4), **tierless)
    reqs = make_requests(cfg, PROMPT_LENS, NEW_TOKENS)
    done, m, wall, launches = serve(cfg, params, dev, reqs, **tierless)
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
    out["profile"] = profile_serve(cfg, params, dev, **tierless)
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
        out["route_diff"] = route_diffs(full_params, full_cfg, tokens, ssm,
                                        "rwkv_wkv", faults)
        out["op_route_diff"] = route_diffs(full_params, full_cfg, tokens,
                                           ssm, "rwkv_wkv", faults,
                                           plain_op=rwkv_wkv_ref)
    log(f"all {full_cfg.n_layers} layers at T = {route_T}: kernel route "
        "against the model's plain scan (bf16 state):")
    check_route_diffs(out["route_diff"], route_T - 1, RWKV_ROUTE_LIMITS)
    log("kernel route against the WKV op's float32 plain version:")
    check_route_diffs(out["op_route_diff"], route_T - 1, RWKV_OP_LIMITS)
    out["preempt"] = preempt_rwkv(cfg, params, dev)
    out["snapshots"] = snapshots_rwkv(cfg, params, dev, out["preempt"])
    del params, full_params
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


# phase 13's served depths (4 each before phase 23 needed the time:
# DeepSeek-V3's 3 dense layers + 1 MoE, dbrx's 4 (attn, moe))
MOE_SERVE_LAYERS = {"deepseek-v3-671b": 2, "dbrx-132b": 2}


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
    base = get_config(arch)
    # a cut keeps at most n_layers - 1 of the dense prefix, so an MoE layer
    # stays
    cfg = dataclasses.replace(base, n_layers=n_layers,
                              layer_prefix=base.layer_prefix[:n_layers - 1])
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
# phase 14's depth cuts (at every published width): mistral-large-123b 4
# of its 88 layers since phase 19 was added (8 before); gemma3-1b 8 of 26
# (one 5:1 block and the two trailing local layers) and gemma-2b 6 of 18
# since phase 22's mesh runs were timed beside a batch-2 engine (uncut
# before); gemma-2b 3 and mistral 2 since phase 23 was added. Phase 14
# (d) trains gemma3-1b uncut
DENSE_LAYERS = {"gemma3-1b": 8, "gemma-2b": 3, "mistral-large-123b": 2}


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
    out["seconds"] = time.perf_counter() - t0
    log(f"{cfg.name} ({cfg.n_layers} layers) took {out['seconds']:.1f} s")
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
    # without the host tier, whose snapshots would cut prefill at block
    # boundaries: the passes and times stay comparable with earlier runs
    tierless = dict(host_cache_mb=0)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4), **kw,
          **tierless)                                             # warm-up
    reqs = make_requests(cfg, DENSE_PROMPT_LENS, NEW_TOKENS)
    with RouteLog() as routes:
        done, m, wall, launches = serve(cfg, params, dev, reqs, **kw,
                                        **tierless)
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
                                       DENSE_PROMPT_LENS[:2], DENSE_MAX_LEN,
                                       **tierless)
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
            cfg, params, dev, fb_reqs, use_attention_kernel=False, **kw,
            **tierless)
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
# the depth cuts (at every published width): musicgen-large 6 of its 48
# layers and internvl2-1b 6 of its 24 since phase 23 was added (12 each
# before; musicgen 24 when phase 22 was added, both uncut before)
FRONTEND_LAYERS = {"musicgen-large": 6, "internvl2-1b": 6}


def frontend_config(arch):
    """``arch``'s config at its published widths, cut in depth to
    ``FRONTEND_LAYERS`` where it names one."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in FRONTEND_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FRONTEND_LAYERS[arch])
    return cfg


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
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import TransformerLM
    cfg = frontend_config(arch)
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
    from repro_torch.core import random as jr
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_optimizer, make_train_step
    from repro_torch.models import frontends
    from repro_torch.models.losses import lm_loss
    from repro_torch.models.transformer import TransformerLM
    cfg = frontend_config(arch)
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


# ---------------------------------------------------------------------------
# Phase 18: the scheduler under saturation on the qwen3-1.7b engine
# ---------------------------------------------------------------------------

def timed_engine(eng, log_to):
    """Wrap ``eng``'s ``preempt_slot`` and ``_resume`` so each call's host
    milliseconds (``torch.cuda.synchronize`` before and after) and each
    park's blocks and bytes of block and recurrent rows go to ``log_to``:
    a park without the host tier its pageable host rows, one through the
    tier the bytes it copied into the arena (and any raw private part),
    the arena entries it added and the shared blocks it pinned."""
    import torch
    park, resume = eng.preempt_slot, eng._resume
    arena = eng.tier.arena if eng.tier is not None else None

    def timed_park(b):
        n0 = len(arena) if arena is not None else 0
        b0 = arena.stats.bytes_in if arena is not None else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req = park(b)
        torch.cuda.synchronize()
        p = eng.parked[req.uid]
        row = {"uid": req.uid, "ms": (time.perf_counter() - t0) * 1e3,
               "blocks": p.nb_live}
        raw = sum(t.numel() * t.element_size() for t in p.private or [])
        row["bytes"] = raw
        if arena is not None:
            row.update(bytes=arena.stats.bytes_in - b0 + raw,
                       arena_entries_added=len(arena) - n0,
                       kv_pinned=len(p.kv_keys), in_arena=p.in_arena)
        log_to.setdefault("park", []).append(row)
        return req

    def timed_resume(req, b, parked):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resume(req, b, parked)
        torch.cuda.synchronize()
        log_to.setdefault("resume", []).append({
            "uid": req.uid, "ms": (time.perf_counter() - t0) * 1e3,
            "slot": b, "parked_shard": parked.shard})

    eng.preempt_slot, eng._resume = timed_park, timed_resume
    return eng


def device_busy_s(prof):
    """``busy_union_s`` read from the profiler's raw device records, without
    building its event tree (which takes minutes for a whole serving
    run)."""
    from torch.autograd import DeviceType
    iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA)
    total, end = 0, -math.inf
    for a, b in iv:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e9


def drive(cfg, params, dev, reqs, hooks=(), before=None, **kw):
    """One engine run of ``reqs`` on the kernel path (``serve``'s engine;
    ``kw`` overrides), the launch counts reset just before it and read
    just after. ``before(eng)`` runs as the engine is built, before the
    submits (a restore). ``hooks`` are ``(steps, fn)``: after that many
    host syncs ``fn(eng)`` runs (an arrival, a forced preemption, a
    cancel). Returns the done requests by uid, the metrics, the wall
    time, the launches, the engine and the park/resume log."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import ServingEngine
    args = dict(batch=2, window_max=8, block_size=16, max_len=256, eps_key=1,
                use_verify_kernel=True, device=dev)
    args.update(kw)
    events = {}
    eng = timed_engine(ServingEngine(cfg, params, **args), events)
    if before is not None:
        before(eng)
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.uid} rejected: {r.error}")
    hooks = sorted(hooks, key=lambda h: h[0])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    syncs = 0
    while eng._pending():
        while hooks and hooks[0][0] == syncs:
            hooks.pop(0)[1](eng)
        if not eng.step():
            break
        syncs += 1
    for _, fn in hooks:
        fn(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    done = {r.uid: r for r in eng.done}
    return done, eng.export_metrics(), wall, launches, eng, events


def margin_fn(cfg, params, dev, tokens, sid):
    """The reference's top-2 margin of ``logits + eps`` at position ``p``
    of ``tokens`` (the dense solo path's logits, plain attention)."""
    import torch
    from repro_torch.engine.agreement import top2_margin
    from repro_torch.engine.spec_decode import make_eps_fn
    from repro_torch.models.transformer import TransformerLM
    eps_fn = make_eps_fn(1, cfg.vocab)

    def margin_at(p):
        toks = torch.as_tensor(tokens[:p], device=dev)[None]
        cache = TransformerLM.init_cache(cfg, 1, p, device=dev)
        logits, _, _ = TransformerLM.decode_window(
            params, cfg, toks, cache,
            torch.zeros(1, dtype=torch.int64, device=dev))
        e = eps_fn(torch.tensor([sid], device=dev),
                   torch.tensor([[p]], device=dev))
        return top2_margin((logits[0, -1].float() + e[0, 0]).cpu())
    return margin_at


def need_path(launches, label, paged=True):
    """The run went through the kernels of its path: spec_verify, and
    paged_decode (the paged round) or paged_write (the legacy round)."""
    key = "paged_decode" if paged else "paged_write"
    if launches["spec_verify"] <= 0 or launches[key] <= 0:
        raise AssertionError(f"{label}: kernel path not taken: {launches}")


def saturation_phase(dev, tol, phase3):
    """Phase 18 on phase 3's qwen3-1.7b (full width, bf16, seed 0) at
    ``block_size=16``, ``max_len=256``, ``window_max=8`` and a fixed W (only
    a fixed W keeps a row's every product shape whoever shares its batch):
    (a) priority preemption, (b) staged adoption against the unstaged
    engine, (c) the cancel of a parked and of a staged request, (d) the
    legacy dense round."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.engine.agreement import check_token_agreement
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    t0 = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    params = TransformerLM.init(cfg, seed=0, device=dev)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))      # warm-up
    # without the host tier: parks go to pageable host memory (phase 19
    # parks through the tier, beside these)
    fixed = dict(adaptive=False, host_cache_mb=0)
    out = {}
    block_bytes = cfg.n_layers * 2 * BS * KV * D * 2

    # (a) two priority-5 requests, then a priority-0 arrival after the
    # first sync
    def lows():
        rng = np.random.default_rng(18)
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L),
                        new_tokens=96, priority=5)
                for i, L in enumerate((40, 80))]
    high = Request(uid=2, prompt=np.random.default_rng(19).integers(
        0, cfg.vocab, 17), new_tokens=32, priority=0)
    base, bm, bwall, _, _, _ = drive(cfg, params, dev, lows(), **fixed)
    got, m, wall, launches, eng, ev = drive(
        cfg, params, dev, lows(), hooks=[(1, lambda e: e.submit(high))],
        **fixed)
    need_path(launches, "phase 18 (a)")
    if not (m["preemptions"] >= 1 and m["resumes"] >= 1):
        raise AssertionError(f"phase 18 (a): no preemption and resume: {m}")
    for u in (0, 1):
        if not (got[u].ok and np.array_equal(got[u].result, base[u].result)
                and got[u].calls_used == base[u].calls_used):
            raise AssertionError(
                f"phase 18 (a): request {u} differs from the run without the "
                f"arrival (calls {got[u].calls_used} vs "
                f"{base[u].calls_used}): {got[u].error}")
    order = [r.uid for r in eng.done]
    parks, resumes = ev.get("park", []), ev.get("resume", [])
    out["preempt"] = {
        "metrics": m, "launches": launches, "done_order": order,
        "park": parks, "resume": resumes, "block_bytes": block_bytes,
        "ms_per_token": wall / m["tokens_generated"] * 1e3,
        "base_ms_per_token": bwall / bm["tokens_generated"] * 1e3,
        "preemptions_by_uid": {u: got[u].preemptions for u in got}}
    log(f"phase 18 (a), a priority-0 arrival after the first sync: "
        f"{m['preemptions']} preemption(s), {m['resumes']} resume(s), done "
        f"order {order}; parked "
        + ", ".join(f"request {p['uid']}: {p['blocks']} blocks, "
                    f"{p['bytes'] / 1e6:.3f} MB to pageable memory "
                    f"({block_bytes / 1e6:.3f} MB of KV a block), park "
                    f"{p['ms']:.3f} ms" for p in parks)
        + "; resume " + ", ".join(f"{r['ms']:.3f} ms" for r in resumes)
        + f"; the low-priority requests' tokens and verify rounds bitwise "
        f"the run without the arrival; {out['preempt']['ms_per_token']:.3f} "
        f"ms per token ({out['preempt']['base_ms_per_token']:.3f} without "
        f"it); launches {launches}; the arrival against the solo sampler "
        f"(margin rule, tolerance {tol}):")
    out["preempt"]["solo"] = solo_agreement(cfg, params, dev, [got[2]], tol)

    out["seconds_after_a"] = time.perf_counter() - t0
    # (b) 8 requests, phase 3's prompt lengths cycled, unstaged and staged
    def eight():
        return make_requests(cfg, PROMPT_LENS * 2, NEW_TOKENS)
    runs, variants = {}, (("unstaged", {}), ("staged", {"staging_slots": 2}))
    for label, kw in variants:
        runs[label] = drive(cfg, params, dev, eight(), rounds_per_sync=8,
                            **fixed, **kw)
    # the busy time of each from a repeat under the profiler (device
    # records only), both repeats after both timed runs
    for label, kw in variants:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            drive(cfg, params, dev, eight(), rounds_per_sync=8, **fixed,
                  **kw)
        runs[label] += (device_busy_s(prof),)
    for label, _ in variants:
        done, m, wall, launches, eng, _, busy = runs[label]
        need_path(launches, f"phase 18 (b) {label}")
        tok = m["tokens_generated"]
        if len(done) != 8 or not all(r.ok for r in done.values()):
            raise AssertionError(f"phase 18 (b) {label}: {len(done)} done")
        runs[label] = {
            "metrics": m, "launches": launches, "wall_s": wall,
            "ms_per_token": wall / tok * 1e3,
            "host_syncs_per_token": m["host_syncs"] / tok,
            "verify_passes": m["verify_passes"],
            "idle_row_rounds": m["idle_row_rounds"],
            "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "done": done}
        log(f"phase 18 (b) {label}: {tok} tokens, {m['host_syncs']} host "
            f"syncs ({runs[label]['host_syncs_per_token']:.4f} per token), "
            f"{m['verify_passes']} verify passes, {m['rounds']} rounds, "
            f"{m['idle_row_rounds']} idle row-rounds, "
            f"{m['in_loop_adoptions']} in-loop adoptions, "
            f"{runs[label]['ms_per_token']:.3f} ms per token, device busy "
            f"{busy:.3f} s, idle share {runs[label]['idle_share']:.4f}; "
            f"launches {launches}")
        if label == "staged":
            if m["in_loop_adoptions"] < 1:
                raise AssertionError("phase 18 (b): no in-loop adoption")
            if not (m["host_syncs"] < runs["unstaged"]["metrics"][
                    "host_syncs"]):
                raise AssertionError(
                    f"phase 18 (b): the staged run synced {m['host_syncs']}"
                    f" times, the unstaged {runs['unstaged']['metrics']}"
                    f"['host_syncs']")
            free = eng.pool.blocks_per_shard - 1
            clean = (not eng.staged and eng.ledger.staged_count(0) == 0
                     and eng.ledger.staged_blocks(0) == 0
                     and all(s is None for s in eng.slots)
                     and eng.n.tolist() == [1, 1]
                     and eng.seq_ids.tolist() == [0, 0]
                     and not eng.tables.any() and not eng.plen.any()
                     and m["blocks_in_use"] == 0
                     and eng.pool.available() == free)
            if not clean:
                raise AssertionError(
                    f"phase 18 (b): the staged engine is not clean: staged "
                    f"{len(eng.staged)}, n {eng.n.tolist()}, blocks in use "
                    f"{m['blocks_in_use']}, available "
                    f"{eng.pool.available()} of {free}")
            runs[label]["prefix_cached_blocks"] = len(
                eng.pool.manager(0).cached_free)
    same = sum(np.array_equal(runs["staged"]["done"][u].result,
                              runs["unstaged"]["done"][u].result)
               for u in range(8))
    log(f"phase 18 (b): {same} of 8 requests bitwise equal in the staged "
        f"and unstaged runs; staged requests against the solo sampler "
        f"(margin rule, tolerance {tol}):")
    agree = solo_agreement(cfg, params, dev,
                           list(runs["staged"]["done"].values()), tol)
    for r in runs.values():
        del r["done"]
    out["staged"] = {"runs": runs, "bitwise_staged_vs_unstaged": int(same),
                     "solo": agree,
                     "solo_bitwise": sum(a["equal"] for a in agree)}
    log(f"phase 18 (b): {out['staged']['solo_bitwise']} of 8 staged "
        f"requests bitwise the solo sampler")

    out["seconds_after_b"] = time.perf_counter() - t0
    # (c) a parked request and a staged request cancelled
    def seven():
        rng = np.random.default_rng(20)
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, L),
                        new_tokens=24 + 4 * i, priority=5 if i < 2 else 6)
                for i, L in enumerate((40, 17, 65, 17, 40, 80, 33))]
    cancelled = {}

    def park(e):
        occ = [b for b in range(2) if e.slots[b] is not None]
        e.preempt_slot(occ[-1])

    def cancel_parked(e):
        uid = next(iter(e.parked))
        assert e.cancel(uid)
        cancelled["parked"] = uid

    def cancel_staged(e):
        if not e.staged:
            raise AssertionError("phase 18 (c): nothing staged to cancel")
        uid = e.staged[0].req.uid
        assert e.cancel(uid)
        cancelled["staged"] = uid
    kw = dict(staging_slots=2, rounds_per_sync=8, adaptive_rounds=False,
              **fixed)
    cbase, _, _, _, _, _ = drive(cfg, params, dev, seven(),
                                 hooks=[(1, park)], **kw)
    got, m, wall, launches, eng, _ = drive(
        cfg, params, dev, seven(),
        hooks=[(1, park), (1, cancel_parked), (2, cancel_staged)], **kw)
    need_path(launches, "phase 18 (c)")
    gone = set(cancelled.values())
    if len(gone) != 2 or m["requests_cancelled"] != 2 or any(
            got[u].error is None or got[u].error.code != "cancelled"
            for u in gone):
        raise AssertionError(f"phase 18 (c): cancels {cancelled}, {m}")
    for u in set(got) - gone:
        if not (got[u].ok and np.array_equal(got[u].result,
                                             cbase[u].result)):
            raise AssertionError(f"phase 18 (c): request {u} differs from "
                                 f"the run without the cancels")
    out["cancel"] = {"cancelled": cancelled, "metrics": m,
                     "launches": launches}
    log(f"phase 18 (c): parked request {cancelled['parked']} and staged "
        f"request {cancelled['staged']} cancelled; the other "
        f"{len(got) - 2} bitwise the run without the cancels; launches "
        f"{launches}")

    out["seconds_after_c"] = time.perf_counter() - t0
    # (d) the legacy dense round on two requests
    reqs = make_requests(cfg, PROMPT_LENS[:2], NEW_TOKENS)
    got, m, wall, launches, _, _ = drive(cfg, params, dev, reqs,
                                         paged_attention=False,
                                         host_cache_mb=0)
    need_path(launches, "phase 18 (d)", paged=False)
    passes = m["verify_passes"] + m["prefill_calls"]
    if launches["paged_decode"] != 0 or \
            launches["paged_write"] != 2 * cfg.n_layers * passes:
        raise AssertionError(f"phase 18 (d): launches {launches}, want "
                             f"paged_write = 2 x {cfg.n_layers} x {passes}")
    base3 = {r.uid: r.result for r in phase3["done"]}
    splits = {u: check_token_agreement(
        base3[u], got[u].result,
        margin_fn(cfg, params, dev, base3[u], got[u].seq_id), tol,
        start=len(got[u].prompt)) for u in (0, 1)}
    tok = m["tokens_generated"]
    out["legacy"] = {"metrics": m, "launches": launches,
                     "ms_per_token": wall / tok * 1e3,
                     "paged_write_per_pass": launches["paged_write"] / passes,
                     "phase3_splits": splits}
    log(f"phase 18 (d), the legacy round (paged_attention=False): {tok} "
        f"tokens, {out['legacy']['ms_per_token']:.3f} ms per token "
        f"(phase 3: {phase3['ms_per_token']:.3f}), paged_write "
        f"{out['legacy']['paged_write_per_pass']:.1f} launches per pass "
        f"({passes} passes), launches {launches}; against phase 3's tokens "
        f"(margin rule, tolerance {tol}): "
        + ", ".join(f"request {u} " + ("equal" if s is None else
                    f"split at {s['position']} (margin {s['margin']:.4g})")
                    for u, s in splits.items()))
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18 took {out['seconds']:.1f} s")
    return out


def timed_tier(eng, log_to):
    """Wrap ``eng``'s spill hook, ``_stage_host_blocks`` and ``_prefill``
    so each call's host milliseconds (``torch.cuda.synchronize`` before and
    after) go to ``log_to``: "spill" (one evicted block each, with whether
    the tier kept it), "restage" (``_restage_host_blocks``, the merge of an
    allocated run, without the allocations, whose evictions spill, with its
    blocks) and "prefill" (with its start and width)."""
    import torch

    def timed(name, fn, info):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log_to.setdefault(name, []).append(
                {"ms": (time.perf_counter() - t0) * 1e3, **info(out, *a)})
            return out
        return call
    mgr = eng.pool.manager(0)
    if mgr.spill_hook is not None:
        mgr.spill_hook = timed("spill", mgr.spill_hook,
                               lambda out, bid, key: {"kept": out})
    eng._restage_host_blocks = timed(
        "restage", eng._restage_host_blocks,
        lambda out, keys, block_ids, s, prefetched=None: {
            "blocks": out, "asked": len(keys)})
    eng._prefill = timed(
        "prefill", eng._prefill,
        lambda out, table_row, b, chunk, start: {"start": start,
                                                 "width": chunk.shape[1]})
    return eng


def serve_in_turn(cfg, params, dev, reqs, **kw):
    """``reqs`` served one after the other by one engine (``drive``'s
    arguments, ``kw`` overrides), each submitted once the one before it is
    done; launches counted from 0 just before and read just after."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import ServingEngine
    args = dict(batch=2, window_max=8, block_size=16, max_len=256, eps_key=1,
                use_verify_kernel=True, device=dev)
    args.update(kw)
    eng = ServingEngine(cfg, params, **args)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.uid} rejected: {r.error}")
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {r.uid: r for r in eng.done}
    return done, eng.export_metrics(), wall, dict(LAUNCHES), eng


def snapshots_rwkv(cfg, params, dev, pageable):
    """Phase 9 (f), the host tier's recurrent snapshots on rwkv6-7b at
    ``host_cache_mb=512``: two requests sharing a 64-token prefix served one
    after the other, the first capturing the state at each of the 4 block
    boundaries and the second restoring the last, against the same traffic
    without the tier. ``prefill_chunk=16``, the block size, so both runs
    prefill in the same 16-wide chunks and the tier's tokens must equal
    the tier-less run's bitwise: that is the gate a wrong restore fails.
    (With 64-wide chunks the tier-less run prefills each prompt in one
    chunk and the snapshot split costs the first request three more
    chunks than the second saves.) Both runs are also held against the
    solo sampler on the plain scan under the margin rule at phase 9's
    tolerance, twice the largest |logit difference| of the kernel and
    plain routes over the served streams: the solo sampler prefills a
    prompt in one pass, so its bf16 products are shaped otherwise than the
    engine's chunks, and that check is loose. Then a forced park through
    the tier (the float32 state rows, one park entry) resumed bitwise the
    undisturbed run, its ms beside phase 9 (e)'s pageable park
    (``pageable``)."""
    import numpy as np
    from repro_torch.serving.admission import Request
    t0 = time.perf_counter()
    prefix = np.random.default_rng(91).integers(0, cfg.vocab, 64)

    def pair():
        return [Request(uid=i, prompt=np.concatenate([prefix, [t]]),
                        new_tokens=NEW_TOKENS) for i, t in enumerate((5, 9))]
    kw = dict(adaptive=False, prefill_chunk=16)
    runs = {}
    for label, mb in (("tier", 512), ("tierless", 0)):
        runs[label] = serve_in_turn(cfg, params, dev, pair(),
                                    host_cache_mb=mb, **kw)
        done, m, wall, launches, _ = runs[label]
        if launches["rwkv_wkv"] <= 0 or launches["spec_verify"] <= 0:
            raise AssertionError(f"phase 9 (f) {label}: kernel path not "
                                 f"taken: {launches}")
        if not all(r.ok for r in done.values()) or len(done) != 2:
            raise AssertionError(f"phase 9 (f) {label}: {done}")
    done, m, wall, launches, eng = runs["tier"]
    mt = runs["tierless"][1]
    if not (m["rec_snapshot_captures"] >= 4
            and m["rec_snapshot_restores"] >= 1
            and m["prefill_calls"] < mt["prefill_calls"]):
        raise AssertionError(
            f"phase 9 (f): captures {m['rec_snapshot_captures']}, restores "
            f"{m['rec_snapshot_restores']}, prefill chunks "
            f"{m['prefill_calls']} against {mt['prefill_calls']} tier-less")
    same = sum(np.array_equal(done[u].result,
                              runs["tierless"][0][u].result) for u in done)
    if same != 2:
        raise AssertionError(f"phase 9 (f): {same} of 2 requests bitwise the "
                             f"tier-less run's, which prefills in the same "
                             f"chunks")
    out = {"metrics": m, "tierless_metrics": mt, "launches": launches,
           "wall_s": wall, "tierless_wall_s": runs["tierless"][2],
           "bitwise_vs_tierless": int(same),
           "prefix_hit_blocks": {u: r.prefix_hit_blocks
                                 for u, r in done.items()}}
    log(f"phase 9 (f), rwkv6-7b snapshots (host_cache_mb=512, "
        f"prefill_chunk=16): {m['rec_snapshot_captures']} captures "
        f"({m['host_bytes_resident'] / 1e6:.1f} MB resident), "
        f"{m['rec_snapshot_restores']} restore(s), prefill chunks "
        f"{m['prefill_calls']} against {mt['prefill_calls']} without the "
        f"tier, prefix hit blocks {out['prefix_hit_blocks']}, {same} of 2 "
        f"requests bitwise the tier-less run's, wall {wall:.3f} s against "
        f"{runs['tierless'][2]:.3f}; launches {launches}")
    gap = route_logit_gap(params, cfg, dev, list(done.values()))
    out["route_logit_gap"] = gap
    log(f"phase 9 (f): largest |logit difference| of the kernel and plain "
        f"routes over these streams {gap:.4g}; against the solo sampler on "
        f"the plain scan (margin rule, tolerance 2 x that = {2 * gap:.4g}):")
    out["solo"] = solo_agreement(cfg, params, dev, list(done.values()),
                                 2 * gap)
    # a forced park through the tier, against the undisturbed run
    reqs = lambda: make_requests(cfg, PROMPT_LENS[:2], NEW_TOKENS)  # noqa
    pkw = dict(adaptive=False, host_cache_mb=512)
    base, _, _, _, _, _ = drive(cfg, params, dev, reqs(), **pkw)

    def park(e):
        occ = [b for b in range(2) if e.slots[b] is not None]
        e.preempt_slot(occ[-1])
    got, pm, _, plaunches, _, ev = drive(cfg, params, dev, reqs(),
                                         hooks=[(1, park)], **pkw)
    if plaunches["rwkv_wkv"] <= 0 or plaunches["spec_verify"] <= 0:
        raise AssertionError(f"phase 9 (f) park: kernel path not taken: "
                             f"{plaunches}")
    if not (pm["preemptions"] == 1 and pm["resumes"] == 1
            and pm["resume_recomputes"] == 0):
        raise AssertionError(f"phase 9 (f) park: {pm}")
    for u in base:
        if not (got[u].ok and np.array_equal(got[u].result, base[u].result)
                and got[u].calls_used == base[u].calls_used):
            raise AssertionError(f"phase 9 (f) park: request {u} differs "
                                 f"from the run without the preemption")
    p, r = ev["park"][0], ev["resume"][0]
    out.update(park=p, resume=r, park_launches=plaunches,
               pageable_park=pageable["park"],
               pageable_resume=pageable["resume"])
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 9 (f), a forced park through the tier: request {p['uid']} "
        f"parked ({p['bytes'] / 1e6:.3f} MB into the arena, in arena "
        f"{p['in_arena']}, {p['ms']:.3f} ms; phase 9 (e)'s pageable park "
        f"{pageable['park']['ms']:.3f} ms) and resumed ({r['ms']:.3f} ms; "
        f"pageable {pageable['resume']['ms']:.3f} ms); both requests' tokens "
        f"and verify rounds bitwise the undisturbed run; phase 9 (f) took "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 19: the host cache tier on the qwen3-1.7b engine
# ---------------------------------------------------------------------------

def ring_rates(tier, dev, reps=10):
    """The staging ring's H2D rate from the arena's pinned kv entries (each
    staged and taken ``reps`` times, host clock after ``synchronize``),
    the same bytes copied from pageable copies of them, the crc32's host
    rate over them, and the ms of a fresh page-locked buffer of each."""
    import torch
    from repro_torch.serving.hostcache import StagingRing, checksum
    rows = [e.tensors for k, e in tier.arena._entries.items()
            if k[0] == "kv"]
    nbytes = sum(t.numel() * t.element_size() for r in rows for t in r)
    ring = StagingRing(depth=2, device=dev)
    pageable = [[t.clone() for t in r] for r in rows]
    out = {"entries": len(rows), "bytes": nbytes}
    for label, src in (("pinned", rows), ("pageable", pageable)):
        for _ in range(2):                       # the first pass warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                for r in src:
                    ring.stage(None, r)
                while ring.take() is not None:
                    pass
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        out[f"{label}_gbps"] = reps * nbytes / dt / 1e9
    t0 = time.perf_counter()
    for r in rows:
        checksum(r)
    out["crc32_gbps"] = nbytes / (time.perf_counter() - t0) / 1e9
    out["overlap_frac"] = ring.stats_export()["h2d_overlap_frac"]
    # what a new arena entry's page-locked buffer costs, kept alive so
    # none comes back from the allocator's cache
    held, ms = [], []
    for r in rows:
        t0 = time.perf_counter()
        held.append([torch.empty_like(t, pin_memory=tier.arena.pinned)
                     for t in r])
        ms.append((time.perf_counter() - t0) * 1e3)
    out["pinned_alloc_ms"] = ms
    return out


def spill_traffic(cfg):
    """Phase 19 (a)'s and 20 (b)'s traffic at batch 1 over 10 usable
    blocks: A (a 64-token prefix and 1 token), B (120 tokens, whose worst
    case takes the whole pool and evicts A's 4 prefix blocks) and C (the
    same prefix and another token), 32 new each."""
    import numpy as np
    from repro_torch.serving.admission import Request
    rng = np.random.default_rng(190)
    prefix = rng.integers(0, cfg.vocab, 64)
    return [Request(uid=0, prompt=np.concatenate([prefix, [11]]),
                    new_tokens=NEW_TOKENS),
            Request(uid=1, prompt=rng.integers(0, cfg.vocab, 120),
                    new_tokens=NEW_TOKENS),
            Request(uid=2, prompt=np.concatenate([prefix, [12]]),
                    new_tokens=NEW_TOKENS)]


def shared_lows(cfg):
    """Phase 19 (b)'s and 20's two priority-5 requests sharing a 40-token
    prompt, 96 new each."""
    import numpy as np
    from repro_torch.serving.admission import Request
    shared = np.random.default_rng(191).integers(0, cfg.vocab, 40)
    return [Request(uid=i, prompt=shared, new_tokens=96, priority=5)
            for i in range(2)]


def shared_highs(cfg):
    """The two priority-0 arrivals (17 tokens, 32 new) that preempt
    ``shared_lows`` after the first sync."""
    import numpy as np
    from repro_torch.serving.admission import Request
    rng = np.random.default_rng(192)
    return [Request(uid=uid, prompt=rng.integers(0, cfg.vocab, 17),
                    new_tokens=NEW_TOKENS, priority=0) for uid in (2, 3)]


def submit_highs(e):
    for r in shared_highs(e.cfg):
        e.submit(r)


def host_tier_phase(dev, tol, sat):
    """Phase 19: the host tier on qwen3-1.7b at full width (bf16, seed 0)
    at a fixed W = 8, every run through ``drive`` (launches counted from 0,
    spec_verify and paged_decode asserted): (a) spill and restage, (b) a
    tiered park of two requests sharing a prompt, (c) faults on the tier;
    park and resume ms beside phase 18 (a)'s pageable ones (``sat``)."""
    import numpy as np
    import torch
    from repro_torch.engine.agreement import check_token_agreement
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.faults import FaultPlan
    t0 = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    params = TransformerLM.init(cfg, seed=0, device=dev)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))      # warm-up
    block_bytes = cfg.n_layers * 2 * BS * KV * D * 2
    out = {"block_bytes": block_bytes}

    # (a) A's 4 prefix blocks evicted by B, restaged for C
    def abc():
        return spill_traffic(cfg)
    # 10 usable blocks: B's worst case (120 + 32 + 8 positions) takes all
    akw = dict(batch=1, num_blocks=11, adaptive=False)
    # once untimed: a process's first page-locked allocation and first
    # upload on a side stream take ~25 ms each on the H100, which the
    # timed runs below should not carry
    drive(cfg, params, dev, abc(), **akw)
    runs = {}
    for label, extra in (("tier", {}), ("tierless", {"host_cache_mb": 0}),
                         ("stage_drop", {"faults": FaultPlan.parse(
                             "stage_drop=@0")})):
        timers = {}
        got, m, wall, launches, eng, _ = drive(
            cfg, params, dev, abc(), hooks=[(0, lambda e, t=timers:
                                             timed_tier(e, t))],
            **akw, **extra)
        need_path(launches, f"phase 19 (a) {label}")
        if len(got) != 3 or not all(r.ok for r in got.values()):
            raise AssertionError(f"phase 19 (a) {label}: {got}")
        runs[label] = dict(done=got, metrics=m, wall_s=wall,
                           launches=launches, timers=timers, eng=eng)
    m, mt = runs["tier"]["metrics"], runs["tierless"]["metrics"]
    c = runs["tier"]["done"][2]
    if not (m["blocks_spilled"] >= 4 and m["host_hits"] >= 1
            and m["host_staged_blocks"] >= 4 and c.prefix_hit_blocks >= 4
            and m["prefill_calls"] < mt["prefill_calls"]
            and mt["blocks_dropped"] >= 4):
        raise AssertionError(
            f"phase 19 (a): spilled {m['blocks_spilled']}, host hits "
            f"{m['host_hits']}, staged {m['host_staged_blocks']}, C's prefix "
            f"hits {c.prefix_hit_blocks}, prefill chunks {m['prefill_calls']}"
            f" against {mt['prefill_calls']}, dropped tier-less "
            f"{mt['blocks_dropped']}")
    for label in ("tierless", "stage_drop"):
        for u in range(3):
            if not np.array_equal(runs[label]["done"][u].result,
                                  runs["tier"]["done"][u].result):
                raise AssertionError(f"phase 19 (a): request {u} of the "
                                     f"{label} run differs from the tier's")
    md = runs["stage_drop"]["metrics"]
    if not (md["staging_errors"] == 1 and md["faults_fired_stage_drop"] == 1):
        raise AssertionError(f"phase 19 (c) stage_drop: {md}")
    tm, tt = runs["tier"]["timers"], runs["tierless"]["timers"]
    spills = [x for x in tm.get("spill", []) if x["kept"]]
    restage = tm["restage"]
    staged_bytes = sum(x["blocks"] for x in restage) * block_bytes
    restage_ms = sum(x["ms"] for x in restage)
    # the tier-less run's prefill of the same positions: C's chunks below
    # the restaged blocks (C is admitted last, so its chunks come last)
    c_chunks = [x for x in tt["prefill"] if x["start"] < 4 * BS][-1:]
    rates = ring_rates(runs["tier"]["eng"].tier, dev)
    out["spill_restage"] = {
        "metrics": m, "tierless_metrics": mt, "stage_drop_metrics": md,
        "launches": runs["tier"]["launches"],
        "spill_ms": [x["ms"] for x in spills],
        "spill_mb": len(spills) * block_bytes / 1e6,
        "restage_ms": restage_ms, "restage_bytes": staged_bytes,
        "restage_gbps": staged_bytes / restage_ms / 1e6,
        "tierless_prefill_ms": sum(x["ms"] for x in c_chunks),
        "tierless_prefill_chunks": c_chunks,
        "h2d_overlap_frac": m["h2d_overlap_frac"], "ring": rates,
        "ms_per_token": runs["tier"]["wall_s"] / m["tokens_generated"] * 1e3,
        "tierless_ms_per_token":
            runs["tierless"]["wall_s"] / mt["tokens_generated"] * 1e3}
    sr = out["spill_restage"]
    log(f"phase 19 (a), spill and restage (batch 1, 10 usable blocks): "
        f"{m['blocks_spilled']} blocks spilled ({len(spills)} copies, "
        f"{sr['spill_mb']:.3f} MB, "
        + ", ".join(f"{x:.3f}" for x in sr["spill_ms"])
        + f" ms each), {m['host_staged_blocks']} restaged in "
        f"{restage_ms:.3f} ms ({sr['restage_gbps']:.2f} GB/s end to end, "
        f"checksums and merges included) against "
        f"{sr['tierless_prefill_ms']:.3f} ms for the tier-less prefill of "
        f"the same positions; prefill "
        f"chunks {m['prefill_calls']} against {mt['prefill_calls']} "
        f"tier-less ({mt['blocks_dropped']} dropped there); h2d_overlap_frac "
        f"{m['h2d_overlap_frac']:.4f}; the ring alone "
        f"{rates['pinned_gbps']:.2f} GB/s from pinned memory, "
        f"{rates['pageable_gbps']:.2f} from pageable, crc32 "
        f"{rates['crc32_gbps']:.3f} GB/s on the host, a fresh pinned "
        f"buffer of a block " + ", ".join(
            f"{x:.3f}" for x in rates["pinned_alloc_ms"])
        + f" ms; C's tokens bitwise "
        f"the tier-less run's; (c) stage_drop=@0: staging_errors "
        f"{md['staging_errors']}, tokens bitwise; launches "
        f"{runs['tier']['launches']}; against the solo sampler (margin rule, "
        f"tolerance {tol}):")
    sr["solo"] = solo_agreement(cfg, params, dev,
                                list(runs["tier"]["done"].values()), tol)
    out["seconds_after_a"] = time.perf_counter() - t0

    # (b) two priority-5 requests sharing a 40-token prompt, both preempted
    # after the first sync by two priority-0 arrivals
    def lows():
        return shared_lows(cfg)
    highs = submit_highs
    shared = lows()[0].prompt
    bkw = dict(adaptive=False)
    base, _, _, _, _, _ = drive(cfg, params, dev, lows(), **bkw)
    parked = {}
    for label, extra in (("tier", {}), ("arena_corrupt", {
            "faults": FaultPlan.parse("arena_corrupt=@0")})):
        got, pm, wall, launches, eng, ev = drive(
            cfg, params, dev, lows(), hooks=[(1, highs)], **bkw, **extra)
        need_path(launches, f"phase 19 (b) {label}")
        for u in (0, 1) if label == "tier" else ():
            if not (got[u].ok and np.array_equal(got[u].result,
                                                 base[u].result)
                    and got[u].calls_used == base[u].calls_used):
                raise AssertionError(
                    f"phase 19 (b) {label}: request {u} differs from the run "
                    f"without the arrivals")
        parked[label] = dict(metrics=pm, launches=launches, ev=ev,
                             done=got)
    pm, ev = parked["tier"]["metrics"], parked["tier"]["ev"]
    parks, resumes = ev.get("park", []), ev.get("resume", [])
    if not (pm["preemptions"] == 2 and pm["resumes"] == 2
            and len(parks) == 2 and parks[1]["arena_entries_added"] == 1
            and pm["resume_recomputes"] == 0):
        raise AssertionError(f"phase 19 (b): parks {parks}, {pm}")
    pc = parked["arena_corrupt"]["metrics"]
    if not (pc["resume_recomputes"] == 1 and pc["checksum_failures"] == 1):
        raise AssertionError(f"phase 19 (c) arena_corrupt: {pc}")
    # the arrivals and the warm resume bitwise (b)'s; the cold resume
    # re-prefills in chunks the positions verify windows of another width
    # wrote, so on the card it holds (b)'s tokens under the margin rule
    corrupt = parked["arena_corrupt"]["done"]
    differ = [u for u in range(4) if not np.array_equal(
        corrupt[u].result, parked["tier"]["done"][u].result)]
    if not set(differ) <= {0, 1} or len(differ) > 1:
        raise AssertionError(f"phase 19 (c) arena_corrupt: requests "
                             f"{differ} differ from (b)'s")
    cold_split = {u: check_token_agreement(
        base[u].result, corrupt[u].result,
        margin_fn(cfg, params, dev, base[u].result, corrupt[u].seq_id), tol,
        start=len(shared)) for u in differ}
    pageable = sat["preempt"]
    out["park"] = {"metrics": pm, "launches": parked["tier"]["launches"],
                   "park": parks, "resume": resumes,
                   "corrupt_metrics": pc, "cold_split": cold_split,
                   "pageable_park": pageable["park"],
                   "pageable_resume": pageable["resume"]}
    log(f"phase 19 (b), two requests sharing a 40-token prompt parked "
        f"through the tier: "
        + ", ".join(f"request {p['uid']}: {p['blocks']} blocks, "
                    f"{p['bytes'] / 1e6:.3f} MB into the arena, "
                    f"{p['arena_entries_added']} entries added, "
                    f"{p['kv_pinned']} shared blocks pinned, {p['ms']:.3f} ms"
                    for p in parks)
        + "; resume " + ", ".join(f"{r['ms']:.3f} ms" for r in resumes)
        + "; phase 18 (a)'s pageable park "
        + ", ".join(f"{p['ms']:.3f} ms ({p['bytes'] / 1e6:.3f} MB)"
                    for p in pageable["park"])
        + ", resume " + ", ".join(f"{r['ms']:.3f} ms"
                                  for r in pageable["resume"])
        + f"; tokens and verify rounds bitwise the run without the arrivals;"
        f" (c) arena_corrupt=@0: resume_recomputes "
        f"{pc['resume_recomputes']}, "
        + (", ".join(f"the cold-resumed request {u} split from (b)'s at "
                     f"{c['position']} (margin {c['margin']:.4g} < {tol})"
                     for u, c in cold_split.items()) if cold_split else
           "every request bitwise (b)'s")
        + f"; launches {parked['tier']['launches']}")
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 19 took {out['seconds']:.1f} s")
    return out


def preempt_rwkv(cfg, params, dev):
    """Phase 9 (e): rwkv6-7b at a fixed W = 8, one forced ``preempt_slot``
    after the first sync (the slot's recurrent rows, float32, parked and
    restored); the tokens and verify rounds equal the same run without it
    bitwise."""
    import numpy as np
    reqs = lambda: make_requests(cfg, PROMPT_LENS[:2], NEW_TOKENS)  # noqa
    kw = dict(adaptive=False, host_cache_mb=0)
    base, _, _, _, _, _ = drive(cfg, params, dev, reqs(), **kw)

    def park(e):
        occ = [b for b in range(2) if e.slots[b] is not None]
        e.preempt_slot(occ[-1])
    got, m, wall, launches, _, ev = drive(
        cfg, params, dev, reqs(), hooks=[(1, park)], **kw)
    if launches["rwkv_wkv"] <= 0 or launches["spec_verify"] <= 0:
        raise AssertionError(f"phase 9 (e): kernel path not taken: "
                             f"{launches}")
    if not (m["preemptions"] == 1 and m["resumes"] == 1):
        raise AssertionError(f"phase 9 (e): {m}")
    for u in base:
        if not (got[u].ok and np.array_equal(got[u].result, base[u].result)
                and got[u].calls_used == base[u].calls_used):
            raise AssertionError(f"phase 9 (e): request {u} differs from "
                                 f"the run without the preemption")
    p, r = ev["park"][0], ev["resume"][0]
    log(f"phase 9 (e), a forced preemption at W = 8: request {p['uid']} "
        f"parked ({p['bytes'] / 1e6:.3f} MB to pageable memory, "
        f"{p['ms']:.3f} ms) and resumed ({r['ms']:.3f} ms); both requests' "
        f"tokens and verify rounds bitwise the run without it; launches "
        f"{launches}")
    return {"park": p, "resume": r, "metrics": m, "launches": launches}


def fs_type(path) -> str:
    """The type of the filesystem that holds ``path``: the longest mount
    point of ``/proc/mounts`` above it."""
    real = os.path.realpath(path)
    best, kind = "", "unknown"
    for line in Path("/proc/mounts").read_text().splitlines():
        f = line.split()
        if len(f) < 3:
            continue
        mnt = f[1].replace("\\040", " ")
        inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
        if inside and len(mnt) > len(best):
            best, kind = mnt, f[2]
    return kind


def timed_durable(eng, log_to):
    """Wrap ``eng``'s journal fsync, checkpoint, disk put and get and the
    tier's disk promotion (read, crc, layout and arena put) so each call's
    host milliseconds go to ``log_to`` ("fsync", "checkpoint", "disk_put"
    with the array bytes and whether it wrote a file (not a dedup),
    "disk_get" with the bytes read, "disk_promote"). All of them run on the
    host only."""
    import torch

    def nbytes(arrays):
        return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
                   else a.nbytes for a in arrays or ())

    def timed(name, fn, info=lambda out, *a: {}):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            log_to.setdefault(name, []).append(
                {"ms": (time.perf_counter() - t0) * 1e3, **info(out, *a)})
            return out
        return call
    if eng.journal is not None:
        eng.journal.sync = timed("fsync", eng.journal.sync)
        eng._checkpoint = timed("checkpoint", eng._checkpoint)
    if eng.disk is not None:
        disk, puts = eng.disk, [eng.disk.stats.puts]

        def wrote(out, name, arrays):
            new = disk.stats.puts > puts[0]
            puts[0] = disk.stats.puts
            return {"ok": out, "wrote": new, "bytes": nbytes(arrays)}
        eng.disk.put = timed("disk_put", eng.disk.put, wrote)
        eng.disk.get = timed("disk_get", eng.disk.get,
                             lambda out, name: {"bytes": nbytes(out)})
        if eng.tier is not None:
            eng.tier._disk_get = timed(
                "disk_promote", eng.tier._disk_get,
                lambda out, *a: {"bytes": nbytes(out)})
    return eng


def ms_stats(rows):
    ms = [x["ms"] for x in rows]
    return {"n": len(ms), "mean_ms": sum(ms) / len(ms) if ms else None,
            "max_ms": max(ms) if ms else None}


def rate_mbps(rows):
    """MB/s of each timed disk call that moved bytes."""
    return [x["bytes"] / x["ms"] / 1e3 for x in rows
            if x.get("bytes") and x["ms"] > 0]


RECOVERY_KILLS = ("post_sync:1", "mid_spill:0")
# phase 20's qwen3-1.7b depth (all 28 layers before phase 24 needed the
# time; every comparison is between engines, or processes, on the same
# weights), and (b)'s arena: two of its blocks (0.9175 MB each)
DURABLE_LAYERS = 14
DISK_ARENA_MB = 2
CHILD_KEYS = ("requests_finished", "prefill_calls", "preemptions",
              "recovered_requests", "recovered_parked", "checkpoints_written",
              "disk_spills", "disk_hits", "disk_promotes", "journal_appends",
              "resume_recomputes", "host_staged_blocks", "tokens_generated")


def recovery_child(make_engine, mode, first, later, keys, extra=dict):
    """One process of a crash-and-restart test: phase 20 (c)'s child on the
    card, ``tests/torch_tp_driver.py``'s kill matrix on the CPU. ``serve``
    builds the engine with ``make_engine``, submits ``first``, steps once,
    submits ``later`` and runs to the end; ``resume`` builds it, restores
    from its durable directory and drains what is left. Prints one flushed
    JSON event per submit ("submitted", once ``submit`` returned: the
    journal holds it), per delivered result ("finish", with its tokens), the
    restore ("recovered": its count, the cold parks, ``recover_ms`` for the
    engine's construction and ``restore`` together, as a restarted process
    spends them, ``restore_ms`` for the ``restore`` call within it, then a
    second, warm pass of the journal's replay and the checkpoint's load),
    then "metrics": ``keys`` of the export, the seconds and ``extra()``.
    ``REPRO_KILL_POINT`` in the environment arms a kill point."""
    from repro_torch.serving.journal import RequestJournal

    def emit(event):
        print(json.dumps(event), flush=True)
    emitted = set()

    def drain():
        for r in eng.done:
            if r.uid not in emitted and r.result is not None:
                emitted.add(r.uid)
                emit({"event": "finish", "uid": int(r.uid),
                      "tokens": [int(t) for t in r.result]})
    t0 = time.perf_counter()
    eng = make_engine()
    if mode == "resume":
        t = time.perf_counter()
        n = eng.restore()
        restore_ms = (time.perf_counter() - t) * 1e3
        recover_ms = (time.perf_counter() - t0) * 1e3
        replay_ms = load_ms = None
        if eng.journal is not None:          # a model rank but 0 has none
            t = time.perf_counter()
            RequestJournal.replay(eng.journal.path)
            replay_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            eng._load_checkpoint()
            load_ms = (time.perf_counter() - t) * 1e3
        emit({"event": "recovered", "n": n,
              "cold": sorted(u for u, p in eng.parked.items() if p.cold),
              "recover_ms": recover_ms, "restore_ms": restore_ms,
              "warm_replay_ms": replay_ms, "warm_load_ms": load_ms})
        drain()
    else:
        for r in first:
            eng.submit(r)
            emit({"event": "submitted", "uid": int(r.uid)})
        eng.step()
        drain()
        for r in later:
            eng.submit(r)
            emit({"event": "submitted", "uid": int(r.uid)})
    while eng._pending():
        if not eng.step():
            break
        drain()
    drain()
    eng.close()
    m = eng.export_metrics()
    emit({"event": "metrics", **{k: m.get(k, 0) for k in keys},
          "serve_s": time.perf_counter() - t0, **extra()})


def run_child(mode, ddir, kill=None, disk_tier=True):
    """``chip_smoke.py --recovery-child`` as a child process on the card,
    ``REPRO_KILL_POINT`` in its environment alone. Returns its return
    code, its events and its wall seconds."""
    env = dict(os.environ)
    env.pop("REPRO_KILL_POINT", None)
    if kill:
        env["REPRO_KILL_POINT"] = kill
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--recovery-child",
           mode, str(ddir)] + ([] if disk_tier else ["--no-disk-tier"])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)
    wall = time.perf_counter() - t0
    events = [json.loads(line) for line in proc.stdout.splitlines()
              if line.startswith("{")]
    if kill is None and proc.returncode != 0:
        raise AssertionError(f"phase 20 (c) {mode} child failed "
                             f"(rc {proc.returncode}): {proc.stderr[-3000:]}")
    return proc.returncode, events, wall


def durable_phase(dev, tol):
    """Phase 20: crash-safe serving of qwen3-1.7b at full width, its first
    ``DURABLE_LAYERS`` layers (bf16, seed 0), at a fixed W = 8, every in-process run through ``drive``
    (spec_verify and paged_decode asserted): (a) phase 19 (b)'s workload
    on a durable engine against the volatile one, (b) phase 19 (a)'s
    through a 4 MiB arena over the disk tier, (c) crash and restart in
    child processes."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine.agreement import check_token_agreement
    from repro_torch.models.transformer import TransformerLM
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=DURABLE_LAYERS)
    params = TransformerLM.init(cfg, seed=0, device=dev)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))      # warm-up
    block_bytes = cfg.n_layers * 2 * BS * KV * D * 2
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="durable-", dir=ROOT / "build"))
    out = {"block_bytes": block_bytes, "fs_type": fs_type(root)}
    try:
        # (a) durability is invisible
        bkw = dict(adaptive=False)
        vol, mv, vwall, vl, _, _ = drive(
            cfg, params, dev, shared_lows(cfg), hooks=[(1, submit_highs)],
            **bkw)
        timers = {}
        dur, md, dwall, dl, _, _ = drive(
            cfg, params, dev, shared_lows(cfg),
            hooks=[(0, lambda e: timed_durable(e, timers)),
                   (1, submit_highs)],
            durable_dir=str(root / "a"), journal_fsync_every=1, **bkw)
        need_path(vl, "phase 20 (a) volatile")
        need_path(dl, "phase 20 (a) durable")
        for u in vol:
            if not (dur[u].ok and np.array_equal(dur[u].result,
                                                 vol[u].result)
                    and dur[u].calls_used == vol[u].calls_used):
                raise AssertionError(f"phase 20 (a): request {u} differs "
                                     f"from the volatile run")
        # 4 submits, an admit per admission and resume, a park per
        # preemption, a finish per request
        appends = 4 + (4 + md["resumes"]) + md["preemptions"] + 4
        if not (md["journal_appends"] == appends and md["preemptions"] == 2
                and md["checkpoints_written"] >= md["host_syncs"]
                and md["disk_spills"] >= 2):
            raise AssertionError(
                f"phase 20 (a): journal_appends {md['journal_appends']} "
                f"(want {appends}), checkpoints {md['checkpoints_written']}"
                f" for {md['host_syncs']} syncs, disk_spills "
                f"{md['disk_spills']}, preemptions {md['preemptions']}")
        out["a"] = {
            "metrics": md, "volatile_metrics": mv, "launches": dl,
            "ms_per_token": dwall / md["tokens_generated"] * 1e3,
            "volatile_ms_per_token": vwall / mv["tokens_generated"] * 1e3,
            "fsync": ms_stats(timers["fsync"]),
            "checkpoint": ms_stats(timers["checkpoint"]),
            "journal_appends_expected": appends,
            "journal_bytes": (root / "a" / "journal.wal").stat().st_size,
            "checkpoint_bytes":
                (root / "a" / "checkpoint.json").stat().st_size}
        a = out["a"]
        log(f"phase 20 (a), phase 19 (b)'s workload on a durable engine "
            f"({out['fs_type']} under build/, journal_fsync_every=1): tokens "
            f"and verify rounds bitwise the volatile run; "
            f"{a['ms_per_token']:.3f} ms per token against "
            f"{a['volatile_ms_per_token']:.3f} volatile; "
            f"{md['journal_appends']} journal records (as the schedule "
            f"implies), {a['journal_bytes']} bytes, {a['fsync']['n']} fsyncs "
            f"(mean {a['fsync']['mean_ms']:.3f} ms, max "
            f"{a['fsync']['max_ms']:.3f}), {md['checkpoints_written']} "
            f"checkpoints for {md['host_syncs']} host syncs (mean "
            f"{a['checkpoint']['mean_ms']:.3f} ms, max "
            f"{a['checkpoint']['max_ms']:.3f}, {a['checkpoint_bytes']} "
            f"bytes), {md['disk_spills']} blocks flushed to disk; launches "
            f"{dl}")

        # (b) the disk fall-through within one process: a 4 MiB arena holds
        # two of the 1.835 MB blocks, so A's 4 prefix blocks go on to disk
        akw = dict(batch=1, num_blocks=11, adaptive=False)
        tt, tm = {}, {}
        base, mt, _, tl, _, _ = drive(
            cfg, params, dev, spill_traffic(cfg),
            hooks=[(0, lambda e: timed_tier(e, tt))], host_cache_mb=0, **akw)
        got, mb, bwall, bl, _, _ = drive(
            cfg, params, dev, spill_traffic(cfg),
            hooks=[(0, lambda e: timed_durable(timed_tier(e, tm), tm))],
            host_cache_mb=DISK_ARENA_MB, durable_dir=str(root / "b"),
            **akw)
        need_path(tl, "phase 20 (b) tier-less")
        need_path(bl, "phase 20 (b) disk")
        for u in base:
            if not (got[u].ok and np.array_equal(got[u].result,
                                                 base[u].result)):
                raise AssertionError(f"phase 20 (b): request {u} differs "
                                     f"from the tier-less run")
        if not (mb["disk_hits"] >= 2 and mb["disk_promotes"] >= 2
                and got[2].prefix_hit_blocks >= 4
                and mb["prefill_calls"] < mt["prefill_calls"]):
            raise AssertionError(
                f"phase 20 (b): disk hits {mb['disk_hits']}, promotes "
                f"{mb['disk_promotes']}, C's prefix hits "
                f"{got[2].prefix_hit_blocks}, prefill chunks "
                f"{mb['prefill_calls']} against {mt['prefill_calls']}")
        puts = [x for x in tm.get("disk_put", []) if x["wrote"]]
        c_chunks = [x for x in tt["prefill"] if x["start"] < 4 * BS][-1:]
        out["b"] = {
            "metrics": mb, "tierless_metrics": mt, "launches": bl,
            "disk_put": puts, "disk_put_mbps": rate_mbps(puts),
            "disk_get": tm.get("disk_get", []),
            "disk_get_mbps": rate_mbps(tm.get("disk_get", [])),
            "disk_promote": tm.get("disk_promote", []),
            "disk_promote_mbps": rate_mbps(tm.get("disk_promote", [])),
            "restage": tm.get("restage", []),
            "restage_ms": sum(x["ms"] for x in tm.get("restage", [])),
            "tierless_prefill_ms": sum(x["ms"] for x in c_chunks),
            "tierless_prefill_chunks": c_chunks,
            "ms_per_token": bwall / mb["tokens_generated"] * 1e3}
        b = out["b"]
        log(f"phase 20 (b), phase 19 (a)'s traffic through a 4 MiB arena "
            f"over the disk tier: {mb['disk_puts']} disk puts ("
            + ", ".join(f"{x['ms']:.3f}" for x in puts) + " ms, "
            + ", ".join(f"{r:.0f}" for r in b["disk_put_mbps"])
            + " MB/s), " + f"{mb['disk_hits']} disk hits (read and crc "
            + ", ".join(f"{x['ms']:.3f}" for x in b["disk_get"]) + " ms, "
            + ", ".join(f"{r:.0f}" for r in b["disk_get_mbps"])
            + " MB/s; with the layout and the arena promotion "
            + ", ".join(f"{x['ms']:.3f}" for x in b["disk_promote"])
            + f" ms), {mb['disk_promotes']} promoted; C's "
            f"{got[2].prefix_hit_blocks} prefix blocks restaged in "
            f"{b['restage_ms']:.3f} ms against {b['tierless_prefill_ms']:.3f}"
            f" ms for the tier-less prefill of the same positions; prefill "
            f"chunks {mb['prefill_calls']} against {mt['prefill_calls']}; "
            f"tokens bitwise the tier-less run's; launches {bl}")

        # (c) crash and restart in child processes
        out["c"] = {}
        for kill in RECOVERY_KILLS:
            point = kill.split(":")[0]
            d = root / f"c_{point}"
            rc, served, swall = run_child("serve", d, kill=kill)
            if rc != -9:
                raise AssertionError(f"phase 20 (c): {kill} child ended "
                                     f"with {rc}, not SIGKILL")
            runs = {"disk": None, "nodisk": None}
            if point == "post_sync":
                shutil.copytree(d, root / "c_nodisk")
            runs["disk"] = run_child("resume", d)
            if point == "post_sync":
                runs["nodisk"] = run_child("resume", root / "c_nodisk",
                                           disk_tier=False)
            submitted = {e["uid"] for e in served
                         if e["event"] == "submitted"}
            row = {"serve_wall_s": swall, "submitted": sorted(submitted)}
            for label, run in runs.items():
                if run is None:
                    continue
                _, resumed, rwall = run
                (rec,) = [e for e in resumed if e["event"] == "recovered"]
                (m,) = [e for e in resumed if e["event"] == "metrics"]
                need_path(m["launches"], f"phase 20 (c) {kill} {label}")
                merged, splits = {}, {}
                for e in served + resumed:
                    if e["event"] != "finish":
                        continue
                    u, toks = e["uid"], np.asarray(e["tokens"])
                    if u in merged and not np.array_equal(merged[u], toks):
                        raise AssertionError(
                            f"phase 20 (c) {kill} {label}: request {u} "
                            f"delivered again with other tokens")
                    merged[u] = toks
                    want = vol[u].result
                    if u in rec["cold"]:
                        # a restored park: its prefill chunks are not the
                        # verify windows that wrote those positions first
                        splits[u] = check_token_agreement(
                            want, toks, margin_fn(cfg, params, dev, want,
                                                  vol[u].seq_id), tol,
                            start=len(vol[u].prompt)) or "bitwise"
                    elif not np.array_equal(toks, want):
                        raise AssertionError(
                            f"phase 20 (c) {kill} {label}: request {u}, "
                            f"admitted again from its prompt, differs from "
                            f"(a)'s volatile run")
                lost = submitted - set(merged)
                if lost or m["recovered_requests"] < 1:
                    raise AssertionError(
                        f"phase 20 (c) {kill} {label}: lost {lost}, {m}")
                if point == "post_sync" and m["recovered_parked"] < 1:
                    raise AssertionError(f"phase 20 (c) {kill}: no park "
                                         f"restored: {m}")
                if label == "disk" and point == "post_sync" \
                        and m["disk_hits"] < 1:
                    raise AssertionError(f"phase 20 (c) {kill}: the restart "
                                         f"hit nothing on disk: {m}")
                row[label] = {"wall_s": rwall, "recovered": rec,
                              "metrics": m, "splits": splits}
            out["c"][point] = row
            dr = row["disk"]
            log(f"phase 20 (c), {kill}: the serving child died by SIGKILL "
                f"after {swall:.1f} s having accepted {sorted(submitted)}; "
                + "; ".join(
                    f"{label} resume ({row[label]['wall_s']:.1f} s): "
                    f"{row[label]['recovered']['n']} recovered, cold parks "
                    f"{row[label]['recovered']['cold']}, engine built and "
                    f"restored in {row[label]['recovered']['recover_ms']:.3f}"
                    f" ms (restore {row[label]['recovered']['restore_ms']:.3f};"
                    f" a second, warm pass: replay "
                    f"{row[label]['recovered']['warm_replay_ms']:.3f}, "
                    f"checkpoint load "
                    f"{row[label]['recovered']['warm_load_ms']:.3f}), prefill "
                    f"chunks {row[label]['metrics']['prefill_calls']}, disk "
                    f"hits {row[label]['metrics']['disk_hits']}, "
                    + (", ".join(
                        f"request {u} " + (s if s == "bitwise" else
                                           f"split at {s['position']} "
                                           f"(margin {s['margin']:.4g} < "
                                           f"{tol})")
                        for u, s in row[label]["splits"].items())
                       or "every request bitwise (a)'s volatile run")
                    for label in ("disk", "nodisk") if label in row)
                + f"; launches {dr['metrics']['launches']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 20 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the hot-path checks, --no-donate and the torch examples
# ---------------------------------------------------------------------------

# each example's flags on the card and the line that states its claim
EXAMPLES = {
    "quickstart_torch.py": ([], "samples bit-identical: True"),
    "serve_llm_torch.py": ([], "every request equals its solo run"),
    "train_multiarch_torch.py": ([], "checkpoint restores bitwise: True"),
    "latent_autoencoder_torch.py": ([], "exact: True"),
}


def serve_engine(cfg, params, dev, reqs, **kw):
    """``serve``'s engine and run, returning the engine too: (done,
    metrics, wall seconds, launches, engine); the metrics also say
    whether a pool leaf's address changed over the run (``pool_moved``)."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, batch=2, window_max=8, block_size=16,
                        max_len=256, eps_key=1, use_verify_kernel=True,
                        device=dev, **kw)
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.uid} rejected: {r.error}")
    ptrs = [leaf.data_ptr() for leaf in eng._paged_leaves()["pool"]]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != len(reqs) or not all(r.ok for r in done):
        raise AssertionError(f"served {len(done)} of {len(reqs)} requests")
    m = dict(eng.export_metrics(), pool_moved=ptrs != [
        leaf.data_ptr() for leaf in eng._paged_leaves()["pool"]])
    return done, m, wall, dict(LAUNCHES), eng


def same_tokens(got, want, label):
    """Tokens and verify rounds of every request bitwise equal."""
    a = {r.uid: r for r in got}
    for r in want:
        if not (a[r.uid].result == r.result).all() \
                or a[r.uid].calls_used != r.calls_used:
            raise AssertionError(f"{label}: request {r.uid} differs")


def loop_census(reports, loop):
    """The checked dispatches' numbers, per variant: W (a loop's first
    argument) or the chunk's width, k (1 for a prefill chunk), transient
    bytes, aten ops and launches per verify pass."""
    rows = []
    for rep in reports:
        if not rep.label.startswith(loop + "@"):
            continue
        m = rep.metrics
        k = m["variant"] or 1
        width = (m["signature"][0][1] if loop != "prefill"
                 else m["signature"][1][0][1])
        rows.append({"W": width, "k": k,
                     "transient_bytes": m["peak_bytes"],
                     "aten_ops_per_pass": m["aten_ops"] / k,
                     "launches_per_pass": m["kernel_launches"] / k,
                     "kernel_calls": m["kernel_calls"],
                     "pool_scatters": m["pool_scatters"],
                     "host_callbacks": m["host_callbacks"],
                     "signatures": m["signatures"]})
    return rows


def hot_path_phase(dev):
    """Phase 21: (a) phase 3's engine and requests with the contracts on,
    unstaged and staged; (b) ``donate=False`` in turns with the in-place
    run; (c) the torch examples on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    out = {}
    cfg = get_config("qwen3-1.7b")
    params = TransformerLM.init(cfg, seed=0, device=dev)
    env0 = os.environ.get("REPRO_CHECK_CONTRACTS")

    def run(checks, **kw):
        os.environ["REPRO_CHECK_CONTRACTS"] = "1" if checks else "0"
        return serve_engine(cfg, params, dev,
                            make_requests(cfg, PROMPT_LENS, NEW_TOKENS), **kw)
    try:
        # (a) the round loops under the contracts and sync-debug "error"
        for key, staging in (("round", 0), ("staged_round", 2)):
            done_off, m_off, wall_off, _, _ = run(False,
                                                  staging_slots=staging)
            done, m, wall, launches, eng = run(True, staging_slots=staging)
            same_tokens(done, done_off, f"21 (a) {key}")
            rows = loop_census(eng.contract_reports, key)
            pre = loop_census(eng.contract_reports, "prefill")
            if not rows or not all(r.ok for r in eng.contract_reports):
                raise AssertionError(f"21 (a) {key}: no checked loop")
            if max(r["signatures"] for r in rows) > 8:
                raise AssertionError(f"21 (a) {key}: signatures {rows}")
            if m["pool_moved"]:
                raise AssertionError(f"21 (a) {key}: a pool moved")
            passes = m["verify_passes"] + m["prefill_calls"]
            out[key] = {"loops": rows, "prefill": pre,
                        "checked": len(eng.contract_reports),
                        "ms_per_token_checked": wall / m[
                            "tokens_generated"] * 1e3,
                        "ms_per_token_unchecked": wall_off / m_off[
                            "tokens_generated"] * 1e3,
                        "verify_passes": m["verify_passes"],
                        "paged_decode_per_pass": launches["paged_decode"]
                        / passes}
            log(f"21 (a) {key}: tokens bitwise the unchecked run; "
                f"{len(eng.contract_reports)} checked dispatches ("
                f"{len(rows)} loops, {len(pre)} prefill widths), all "
                f"passing under sync-debug 'error'; pools kept")
            for r in rows + pre:
                log(f"  W = {r['W']}, k = {r['k']}: "
                    f"{r['transient_bytes'] / 1e6:.3f} MB "
                    f"transient, {r['aten_ops_per_pass']:.1f} aten ops and "
                    f"{r['launches_per_pass']:.1f} launches per pass "
                    f"({r['kernel_calls']}), pool scatters "
                    f"{r['pool_scatters']}, host reads "
                    f"{r['host_callbacks']}, signatures {r['signatures']}")
            log(f"  ms per token {out[key]['ms_per_token_checked']:.3f} "
                f"checked, {out[key]['ms_per_token_unchecked']:.3f} not")
            del eng
        # (b) --no-donate in turns with the in-place run
        os.environ["REPRO_CHECK_CONTRACTS"] = "0"
        turns = {"in_place": [], "no_donate": []}
        ref = None
        for key in ("in_place", "no_donate", "no_donate", "in_place"):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            done, m, wall, _, eng = run(False, donate=key == "in_place")
            peak = torch.cuda.max_memory_allocated() - base
            del eng
            if ref is None:
                ref = done
            same_tokens(done, ref, f"21 (b) {key}")
            turns[key].append({"ms_per_token": wall / m["tokens_generated"]
                               * 1e3, "peak_bytes": peak})
        out["no_donate"] = turns
        log("21 (b) --no-donate: tokens bitwise the in-place run; ms per "
            "token in place " + ", ".join(
                f"{t['ms_per_token']:.3f}" for t in turns["in_place"])
            + ", copied " + ", ".join(
                f"{t['ms_per_token']:.3f}" for t in turns["no_donate"])
            + "; peak MB above the weights in place " + ", ".join(
                f"{t['peak_bytes'] / 1e6:.1f}" for t in turns["in_place"])
            + ", copied " + ", ".join(
                f"{t['peak_bytes'] / 1e6:.1f}" for t in turns["no_donate"]))
    finally:
        if env0 is None:
            os.environ.pop("REPRO_CHECK_CONTRACTS", None)
        else:
            os.environ["REPRO_CHECK_CONTRACTS"] = env0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the torch examples, at once, each its own process on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, (flags, _) in EXAMPLES.items():
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / name), *flags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(ROOT)))
    out["examples"] = {}
    for name, (t0, p) in procs.items():
        try:
            text, _ = p.communicate(timeout=300)
        finally:
            p.kill()
        secs = time.perf_counter() - t0
        claim = EXAMPLES[name][1]
        out["examples"][name] = {"rc": p.returncode, "seconds": secs,
                                 "claim": claim in text,
                                 "tail": text[-600:]}
        log(f"21 (c) {name}: exit {p.returncode}, {secs:.1f} s, "
            f"claim {'printed' if claim in text else 'MISSING'}")
        if p.returncode != 0 or claim not in text:
            log(text[-3000:])
            raise AssertionError(f"21 (c): {name} failed")
    return out


def timed_migrations(eng, log_to, block_bytes):
    """Wrap ``eng``'s ``migrate_slot`` so each call's host milliseconds
    (``torch.cuda.synchronize`` before and after), blocks copied across
    shards, MB and GB/s go to ``log_to["migrate"]``."""
    import torch
    migrate = eng.migrate_slot

    def timed(b_src, b_dst):
        n0 = eng.metrics.blocks_migrated
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        migrate(b_src, b_dst)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        blocks = eng.metrics.blocks_migrated - n0
        log_to.setdefault("migrate", []).append({
            "from": b_src, "to": b_dst, "ms": ms, "blocks": blocks,
            "mb": blocks * block_bytes / 1e6,
            "gb_per_s": blocks * block_bytes / 1e6 / ms})
    eng.migrate_slot = timed
    return eng


# phase 22's qwen3-1.7b depth (all 28 layers before phase 23 needed the
# time, 14 before phase 24 did; the comparisons are between engines on the
# same weights)
MESH_LAYERS = 7


def mesh_phase(dev, n_layers=MESH_LAYERS):
    """Phase 22: the data-parallel mesh engine on phase 3's qwen3-1.7b
    (full width, bf16, seed 0; its first ``n_layers`` layers), two shards
    on this card, at a fixed W = 8
    (``block_size=16``, ``max_len=256``, no host tier), every run through
    ``drive``: (a) phase 18's 8 requests at data = 2, batch 4, bitwise a
    data = 1 engine at batch 2 (two rows per call on both) and under the
    margin rule one at batch 4 (cuBLAS may pick another algorithm for 32
    rows), ms per token, host syncs and the idle share of all three, timed
    here side by side; (b) after the first sync slot 0 is preempted and shard 1's first request
    migrates into it, so the parked request resumes on shard 1: once under
    the contracts (the copy and every round under sync-debug "error"), once
    timed, tokens bitwise (a)'s; (c) a rebalancing admission, the
    reference's ``saturation_mesh`` at this block size: an arrival no shard
    can take is admitted in the same pass once a resident migrates, tokens
    bitwise the run without rebalancing."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.engine.agreement import check_token_agreement
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    from repro_torch.serving.topology import ServingTopology
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=n_layers)
    params = TransformerLM.init(cfg, seed=0, device=dev)
    serve(cfg, params, dev, make_requests(cfg, (17,), 4))      # warm-up
    out = {"setup_seconds": time.perf_counter() - t0}
    card = (torch.device("cuda", torch.cuda.current_device())
            if dev.type == "cuda" else dev)          # both shards' device
    fixed = dict(adaptive=False, host_cache_mb=0, rounds_per_sync=8)
    block_bytes = cfg.n_layers * 2 * BS * KV * D * 2

    def mesh2():
        return dict(topology=ServingTopology(make_host_mesh(
            2, devices=(card, card))), batch=4, device=None)

    def eight():
        return make_requests(cfg, PROMPT_LENS * 2, NEW_TOKENS)
    out["block_bytes"] = block_bytes

    # (a) data = 2 at batch 4 against data = 1 at batch 2 and at batch 4
    shards_of = []

    def watch(e):
        admit = e._admit

        def counted(req, b):
            shards_of.append(b // e.B_local)
            return admit(req, b)
        e._admit = counted
    variants = [("data2_b4", mesh2), ("data1_b4", lambda: dict(batch=4)),
                ("data1_b2", lambda: dict(batch=2))]
    runs = {}
    for label, kw in variants:
        hooks = [(0, watch)] if label == "data2_b4" else []
        runs[label] = drive(cfg, params, dev, eight(), hooks=hooks, **fixed,
                            **kw())
    for label, kw in variants:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            drive(cfg, params, dev, eight(), **fixed, **kw())
        runs[label] += (device_busy_s(prof),)
    if sorted(set(shards_of)) != [0, 1]:
        raise AssertionError(f"phase 22 (a): admissions by shard "
                             f"{shards_of}")
    done = {}
    for label, _ in variants:
        got, m, wall, launches, _, _, busy = runs[label]
        need_path(launches, f"phase 22 (a) {label}")
        if len(got) != 8 or not all(r.ok for r in got.values()):
            raise AssertionError(f"phase 22 (a) {label}: {len(got)} done")
        done[label] = {u: r.result for u, r in got.items()}
        runs[label] = {"metrics": m, "launches": launches, "wall_s": wall,
                       "ms_per_token": wall / m["tokens_generated"] * 1e3,
                       "host_syncs": m["host_syncs"],
                       "verify_passes": m["verify_passes"],
                       "device_busy_s": busy, "idle_share": 1 - busy / wall}
    for label, r in runs.items():
        m = r["metrics"]
        log(f"phase 22 (a) {label}: {m['tokens_generated']} tokens, "
            f"{r['host_syncs']} host syncs, {r['verify_passes']} verify "
            f"passes, {m['rounds']} rounds, {r['ms_per_token']:.3f} ms per "
            f"token, device busy {r['device_busy_s']:.3f} s, idle share "
            f"{r['idle_share']:.4f}; launches {r['launches']}")
    for u in range(8):
        if not np.array_equal(done["data2_b4"][u], done["data1_b2"][u]):
            raise AssertionError(f"phase 22 (a): request {u} at data 2 "
                                 "differs from data 1 at batch 2")
    lens = PROMPT_LENS * 2
    splits = {u: check_token_agreement(
        done["data1_b4"][u], done["data2_b4"][u],
        margin_fn(cfg, params, dev, done["data1_b4"][u], u), 0.25,
        start=lens[u]) for u in range(8)}
    out["a"] = {"runs": runs, "admissions_by_shard": shards_of,
                "splits_vs_data1_b4": splits}
    log(f"phase 22 (a): admissions by shard {shards_of}; data 2 bitwise "
        f"data 1 at batch 2 (8 of 8); against data 1 at batch 4 (margin "
        f"rule, tolerance 0.25): " + ", ".join(
            f"request {u} " + ("equal" if s is None else
                               f"split at {s['position']} (margin "
                               f"{s['margin']:.4g})")
            for u, s in splits.items()))

    out["seconds_after_a"] = time.perf_counter() - t0
    # (b) a preemption and a cross-shard migration after the first sync
    def disturb(log_to):
        def hook(e):
            if not all(s is not None for s in e.slots):
                raise AssertionError("phase 22 (b): a slot is free at "
                                     "sync 1")
            timed_migrations(e, log_to, block_bytes)
            e.preempt_slot(0)
            e.migrate_slot(2, 0)
        return hook
    env0 = os.environ.get("REPRO_CHECK_CONTRACTS")
    moved = {}
    try:
        for label, checks in (("checked", "1"), ("timed", "0")):
            os.environ["REPRO_CHECK_CONTRACTS"] = checks
            moved[label] = {}
            got, m, wall, launches, eng, ev = drive(
                cfg, params, dev, eight(),
                hooks=[(1, disturb(moved[label]))], **fixed, **mesh2())
            need_path(launches, f"phase 22 (b) {label}")
            res = ev.get("resume", [])
            if not (m["migrations"] == 1 and m["preemptions"] == 1
                    and len(res) == 1
                    and res[0]["slot"] // 2 != res[0]["parked_shard"]):
                raise AssertionError(f"phase 22 (b) {label}: migrations "
                                     f"{m['migrations']}, resumes {res}")
            for u in range(8):
                if not (got[u].ok and np.array_equal(
                        got[u].result, done["data2_b4"][u])):
                    raise AssertionError(f"phase 22 (b) {label}: request {u}"
                                         " differs from (a)'s")
            if checks == "1":
                reps = eng.contract_reports
                kinds = {r.contract for r in reps}
                if not (reps and all(r.ok for r in reps)
                        and "MIGRATION_COPY_CONTRACT" in kinds):
                    raise AssertionError(f"phase 22 (b): contracts {kinds}")
                moved[label]["contracts"] = sorted(kinds)
                moved[label]["checked"] = len(reps)
            moved[label].update(metrics=m, launches=launches,
                                park=ev.get("park"), resume=res)
    finally:
        if env0 is None:
            os.environ.pop("REPRO_CHECK_CONTRACTS", None)
        else:
            os.environ["REPRO_CHECK_CONTRACTS"] = env0
    out["b"] = moved
    for label, row in moved.items():
        mig = row["migrate"][0]
        log(f"phase 22 (b) {label}: request parked from shard "
            f"{row['resume'][0]['parked_shard']} resumed in slot "
            f"{row['resume'][0]['slot']}; migration {mig['blocks']} blocks, "
            f"{mig['mb']:.3f} MB in {mig['ms']:.3f} ms "
            f"({mig['gb_per_s']:.3f} GB/s); tokens bitwise (a)'s"
            + (f"; {row['checked']} checked dispatches "
               f"({', '.join(row['contracts'])}), none raised under "
               "sync-debug 'error'" if label == "checked" else ""))

    out["seconds_after_b"] = time.perf_counter() - t0
    # (c) rebalancing: per shard 16 usable blocks; a long request (12
    # blocks) pins shard 0, two short ones (4 each) fill shard 1's slots,
    # an arrival needing 6 fits neither shard until a short one migrates
    rng = np.random.default_rng(22)

    def saturation():
        return [Request(uid=i, prompt=p, new_tokens=n) for i, (p, n) in
                enumerate(zip(prompts, (100, 32, 32, 40)))]
    prompts = [rng.integers(0, cfg.vocab, L) for L in (80, 17, 17, 40)]
    rebal = {}
    for label, on in (("on", True), ("off", False)):
        admitted = []

        def first(e, admitted=admitted):
            admitted.append(len(e.queue) == 0)
        log_to = {}
        got, m, wall, launches, eng, _ = drive(
            cfg, params, dev, saturation(),
            hooks=[(0, lambda e, log_to=log_to: timed_migrations(
                e, log_to, block_bytes)), (1, first)],
            rebalance=on, prefix_cache=False, num_blocks=17, **fixed,
            **mesh2())
        need_path(launches, f"phase 22 (c) {label}")
        rebal[label] = {"done": got, "admitted_same_pass": admitted[0],
                        "metrics": m, "migrate": log_to.get("migrate", []),
                        "ms_per_token": wall / m["tokens_generated"] * 1e3}
    on, off = rebal["on"], rebal["off"]
    if not (on["admitted_same_pass"] and not off["admitted_same_pass"]
            and on["metrics"]["migrations"] >= 1):
        raise AssertionError(f"phase 22 (c): admitted {on['admitted_same_pass']}"
                             f" / {off['admitted_same_pass']}, migrations "
                             f"{on['metrics']['migrations']}")
    for u in range(4):
        if not np.array_equal(on["done"][u].result, off["done"][u].result):
            raise AssertionError(f"phase 22 (c): request {u} differs with "
                                 "rebalancing")
    for r in rebal.values():
        del r["done"]
    out["c"] = rebal
    log(f"phase 22 (c): the arrival admitted in the first pass with "
        f"rebalancing ({on['metrics']['migrations']} migration(s): "
        + ", ".join(f"{g['blocks']} blocks in {g['ms']:.3f} ms"
                    for g in on["migrate"])
        + "), queued without; tokens bitwise; "
        f"{on['ms_per_token']:.3f} / {off['ms_per_token']:.3f} ms per token")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 22 took {out['seconds']:.1f} s")
    return out


# ---- phase 23: the model axis (tensor and expert parallelism) -----------

DBRX_EP_LAYERS = 2       # the dbrx-132b cut served on the model axis
# (a)'s window logits at model 2 against model 1's, max-abs, and the margin
# rule's tolerance there: the geometric mean, rounded down, of the sound
# reading and the least planted fault's, both on an H100 (PERF.md): 0.2 at
# 28 layers (0.1094, 0.3828: layer 27's MLP all_reduce left out) and again
# at 14 (0.08594, 0.4902: layer 13's); every run asserts it still parts
# the two
TP_LOGITS_TOL = 0.2
# (a)'s qwen3-1.7b depth (all 28 layers before phase 24 needed the time)
TP_LAYERS = 14
# the layers whose collectives are planted: the first, middle and last
TP_FAULT_LAYERS = (0, TP_LAYERS // 2, TP_LAYERS - 1)
# (a)'s durable run is copied for (d) right after the first host sync at
# which this many of its 8 requests are done (a crash there would leave
# the copy); (e): a long request past ``CLOCK_MAX_S`` seconds, a short one
# with a deadline of ``CLOCK_DEADLINE_S``, and rank 1's clock 1000 + 7 t
DURABLE_SNAP_DONE = 5
CLOCK_MAX_S = 1.5
CLOCK_DEADLINE_S = 0.05
CLOCK_SKEW = (1000.0, 7.0)


class _OtherRank:
    """A model axis that reports the other rank of two and reduces as
    ``axis`` does: a leaf placed over it reads the other rank's slice."""

    def __init__(self, axis):
        self.axis, self.name = axis, axis.name
        self.rank, self.size = 1 - axis.rank, axis.size

    def all_reduce(self, t):
        return self.axis.all_reduce(t)

    def all_gather(self, t, dim=-1):
        return self.axis.all_gather(t, dim)


def planted_faults(cfg, params, dev, axis, ref):
    """Qwen's window logits at model 2 under planted tensor-parallel
    faults, each made alike on both ranks, as max-abs against ``ref``
    (model 1's): the embedding's all_reduce left out, one layer's
    attention-output or MLP all_reduce left out (each rank keeps its
    partial sum), and one layer's ``wo`` reading the other rank's input
    slice. A pass's all_reduce calls run: the embedding's, then each
    layer's wq, wk, wv, wo and MLP down."""
    import itertools
    from repro_torch.sharding import tensor_parallel as tp
    real = axis.all_reduce

    def err():
        return float((window_logits(cfg, params, dev).float() - ref)
                     .abs().max())
    skips = {"embedding all_reduce left out": 0}
    for l in TP_FAULT_LAYERS:
        skips[f"layer {l} wo all_reduce left out"] = 1 + 5 * l + 3
        skips[f"layer {l} MLP all_reduce left out"] = 1 + 5 * l + 4
    out = {}
    for label, n in skips.items():
        calls = itertools.count()
        axis.all_reduce = lambda t: t if next(calls) == n else real(t)
        try:
            out[label] = err()
        finally:
            del axis.all_reduce
    for l in TP_FAULT_LAYERS:
        w = params["layers"][l]["mixer"]["wo"]["w"]
        pls = tp.placements_of(w)
        pl = pls["model"]
        setattr(w, tp._ATTR, {**pls, "model": tp.Placement(
            _OtherRank(axis), pl.dim, pl.shape)})
        try:
            out[f"layer {l} wo on the other rank's input slice"] = err()
        finally:
            setattr(w, tp._ATTR, pls)
    return out


def tp_traffic(cfg, new_tokens=None):
    """The reference's tensor-parallel scenario (``tests/serving/
    test_mesh_engine.py``'s TP_SCRIPT: 4 requests, prompts of 2-6 tokens,
    3-5 new) at ``cfg``'s vocabulary; ``new_tokens`` fixes the lengths."""
    import numpy as np
    from repro_torch.serving.admission import Request
    rng = np.random.default_rng(3)
    out = []
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(2, 7)))
        n = int(rng.integers(3, 6))
        out.append(Request(uid=i, prompt=prompt,
                           new_tokens=new_tokens or n))
    return out


def window_logits(cfg, params, dev, rows=2, width=8):
    """A paged verify window's logits on the kernel path: ``rows`` rows of
    ``width`` tokens (numpy seed 23) from position 0 over fresh pools."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import PagedView, TransformerLM
    nb = -(-width // BS)
    paged = TransformerLM.init_paged_cache(cfg, rows, 1 + rows * nb, BS,
                                           device=dev)
    tables = (1 + torch.arange(rows * nb, device=dev)).view(rows, nb).int()
    toks = torch.as_tensor(np.random.default_rng(23).integers(
        0, cfg.vocab, (rows, width)), device=dev)
    logits, _, _ = TransformerLM.decode_window_paged(
        params, cfg, toks, paged, PagedView(tables, torch.arange(
            rows, device=dev), True), torch.zeros(rows, dtype=torch.int64,
                                                  device=dev))
    return logits


def served(done):
    """A run's requests as plain data for the parent, by uid: uid, prompt,
    new tokens, result."""
    return [{"uid": r.uid, "prompt": r.prompt.tolist(),
             "new_tokens": r.new_tokens, "result": r.result.tolist()}
            for r in sorted(done.values(), key=lambda r: r.uid)]


def clock_requests(cfg):
    """(e)'s traffic: a long request (cut by ``max_request_seconds``), a
    short one with a deadline (which ranks it first in the queue, and
    which it misses) and a short one without."""
    long_, short, other = make_requests(cfg, (17, 17, 17), 4)
    long_.new_tokens = 96
    short.deadline = CLOCK_DEADLINE_S
    return [long_, short, other]


def copy_durable(src, dst, rank):
    """Rank ``rank``'s files of durable directory ``src`` into ``dst``:
    rank 0's journal, checkpoint and disk tier, rank r's ``rank{r}/``."""
    import shutil
    os.makedirs(dst, exist_ok=True)
    names = (["journal.wal", "checkpoint.json", "disk"] if rank == 0
             else [f"rank{rank}"])
    for name in names:
        a, b = os.path.join(src, name), os.path.join(dst, name)
        if os.path.isdir(a):
            shutil.copytree(a, b)
        elif os.path.exists(a):
            shutil.copy2(a, b)


def model_axis_rank(rank, world, store_path, durable_root):
    """Phase 23's model rank ``rank`` of 2 (a process of its own, started
    by ``collectives.spawn``; the kernels the parent built are loaded).
    Both ranks share this card over gloo. Returns what it measured: (a)
    qwen3-1.7b at full width (its first ``TP_LAYERS`` layers), data 1 x
    model 2, its served run durable under ``durable_root/a`` (rank 0's
    journal and checkpoints, each rank's disk tier); (b) data 2 x model
    2; (c) the dbrx-132b cut, expert-parallel; (d) a fresh engine over
    the copy of (a)'s directory taken mid-run (``DURABLE_SNAP_DONE``)
    restored and run to the end; (e) a deadline and
    ``max_request_seconds`` with rank 1's clock skewed here."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.analysis import Census
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import MoE
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.topology import ServingTopology
    from repro_torch.sharding.moe_shard import _moe_ep_only
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    topo = ServingTopology(make_host_mesh(1, 2, devices=(dev,), rank=rank,
                                          store_path=store_path))
    axis = topo.model_axis
    out = {"rank": axis.rank, "backend": topo.mesh.backend}
    fixed = dict(adaptive=False, host_cache_mb=0, rounds_per_sync=8)

    # (a) qwen3-1.7b, data 1 x model 2: slices, the window's logits
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=TP_LAYERS)
    full = TransformerLM.init(cfg, seed=0, device=dev)
    ref = window_logits(cfg, full, dev).float()
    params = topo.place_params(cfg, full)
    del full
    torch.cuda.empty_cache()
    kernels.reset_launches()
    with Census() as c:
        got = window_logits(cfg, params, dev).float()
    a = {"setup_s": time.perf_counter() - t0,
         "param_gb": torch.cuda.memory_allocated() / 1e9,
         "logits_max_abs_err": float((got - ref).abs().max()),
         "argmax_equal": int((got.argmax(-1) == ref.argmax(-1)).sum()),
         "argmax_of": int(ref.shape[0] * ref.shape[1]),
         "census": c.collectives_by_axis, "census_launches": c.launches,
         "faults": planted_faults(cfg, params, dev, axis, ref)}
    del got, ref
    serve_kw = dict(topology=topo, device=None, **fixed)
    drive(cfg, params, dev, make_requests(cfg, (17,), 2), **serve_kw)
    # durable; right after the first host sync at which
    # ``DURABLE_SNAP_DONE`` requests are done each rank copies its files
    # for (d), as a crash after that sync's checkpoint would leave them
    adir = os.path.join(durable_root, "a")
    ddir = os.path.join(durable_root, "d")
    timers, snap = {}, {}

    def snapshot(e):
        if not snap and len(e.done) >= DURABLE_SNAP_DONE:
            copy_durable(adir, ddir, axis.rank)
            snap.update(sync=e.metrics.host_syncs, done=len(e.done))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got, m, wall, launches, eng, _ = drive(
            cfg, params, dev, make_requests(cfg, PROMPT_LENS * 2,
                                            NEW_TOKENS),
            hooks=[(n, snapshot) for n in range(1, 4000)],
            before=lambda e: timed_durable(e, timers), durable_dir=adir,
            **serve_kw)
    del eng
    busy = device_busy_s(prof)
    a.update(served=served(got), metrics=m, wall_s=wall, launches=launches,
             ms_per_token=wall / m["tokens_generated"] * 1e3,
             device_busy_s=busy, idle_share=1 - busy / wall,
             fsync=ms_stats(timers.get("fsync", [])),
             checkpoint=ms_stats(timers.get("checkpoint", [])),
             snapshot=snap)
    # the gather fallback (the writeback kernel) at model 2
    got, m, _, launches, _, _ = drive(
        cfg, params, dev, make_requests(cfg, (17,), 4),
        use_attention_kernel=False, **serve_kw)
    a.update(fallback_served=served(got), fallback_launches=launches,
             fallback_passes=m["verify_passes"] + m["prefill_calls"],
             seconds=time.perf_counter() - t0)
    out["a"] = a

    # (d) a fresh engine over (a)'s mid-run copy: restore, run to the end
    t0 = time.perf_counter()
    rst = {}

    def restore(e):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rst["recovered"] = e.restore()
        rst["restore_ms"] = (time.perf_counter() - t) * 1e3
        rst["redelivered"] = len(e.done)
    got, m, wall, launches, _, _ = drive(cfg, params, dev, [],
                                         before=restore, durable_dir=ddir,
                                         **serve_kw)
    out["d"] = dict(rst, served=served(got), metrics=m, wall_s=wall,
                    launches=launches, seconds=time.perf_counter() - t0)

    # (e) the engine's clock: rank 1's own reads 1000 + 7 t, here only
    t0 = time.perf_counter()
    real = time.monotonic
    if axis.rank == 1:
        time.monotonic = lambda: CLOCK_SKEW[0] + CLOCK_SKEW[1] * real()
    try:
        got, m, wall, launches, _, _ = drive(
            cfg, params, dev, clock_requests(cfg),
            max_request_seconds=CLOCK_MAX_S, **serve_kw)
    finally:
        time.monotonic = real
    out["e"] = {"outcomes": {int(u): {
        "error": r.error.code if r.error else None,
        "missed_deadline": bool(r.missed_deadline),
        "result": None if r.result is None else r.result.tolist()}
        for u, r in got.items()},
        "metrics": {k: m[k] for k in ("requests_failed", "requests_finished",
                                      "host_syncs", "verify_passes")},
        "launches": launches, "seconds": time.perf_counter() - t0}

    # (b) the reference's TP traffic (its prompts, 8 new tokens each so
    # that every request is live at the first sync) at data 2 x model 2,
    # batch 4, against data 1 x model 2 at batch 2 (the same rows a call),
    # and again with a preemption and a cross-shard migration after the
    # first sync (one round a sync)
    t0 = time.perf_counter()
    mesh2 = ServingTopology(make_host_mesh(2, 2, devices=(dev, dev)))
    tp_kw = dict(window_max=4, max_len=32, block_size=4, adaptive=False,
                 host_cache_mb=0, device=None, rounds_per_sync=1)
    moved = {}

    def disturb(e):
        timed_migrations(e, moved, cfg.n_layers * 2 * 4 * KV * D * 2)
        e.preempt_slot(0)
        src = next(s for s in (2, 3) if e.slots[s] is not None)
        e.migrate_slot(src, 0)
    b = {}
    for label, kw, hooks in (
            ("data2_b4", dict(topology=mesh2, batch=4), []),
            ("data1_b2", dict(topology=topo, batch=2), []),
            ("migrated", dict(topology=mesh2, batch=4), [(1, disturb)])):
        got, m, wall, launches, _, ev = drive(
            cfg, params, dev, tp_traffic(cfg, 8), hooks=hooks, **tp_kw,
            **kw)
        b[label] = {"served": served(got), "metrics": m,
                    "launches": launches, "resume": ev.get("resume", [])}
    b["migrate"] = moved.get("migrate", [])
    b["seconds"] = time.perf_counter() - t0
    out["b"] = b
    del params
    torch.cuda.empty_cache()

    # (c) the dbrx-132b cut, expert-parallel: the MoE layer against the
    # whole layer on the same input, then served with its routing logged
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              n_layers=DBRX_EP_LAYERS)
    full = TransformerLM.init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn((2, 8, cfg.d_model), generator=gen,
                    device=dev).to(cfg.param_dtype)
    y_ref, _ = MoE.apply(full["layers"][0]["ffn"], x, cfg,
                         capacity_factor=None)
    params = topo.place_params(cfg, full)
    del full
    torch.cuda.empty_cache()
    p = params["layers"][0]["ffn"]
    y_ep, _ = _moe_ep_only(p, x, cfg, None, axis)
    err = (y_ep.float() - y_ref.float()).abs()
    # the same layer in float32 (this rank's experts cast), for the CPU
    # test's bound, against the whole layer the parent casts alike
    p32 = {"router": {"w": p["router"]["w"].float()},
           "experts": {k: v.float() for k, v in p["experts"].items()}}
    y32, _ = _moe_ep_only(p32, x.float(), cfg, None, axis)
    del p32
    torch.cuda.empty_cache()
    c = {"setup_s": time.perf_counter() - t0,
         "experts_local": int(p["experts"]["up"].shape[0]),
         "moe_max_abs_err": float(err.max()),
         # in bf16 each side rounds its float32 sum once: one ulp apart
         "moe_within": bool((err <= 2 ** -7 * y_ref.float().abs()).all()),
         "y_ep_float32": y32.tolist(),
         "moe_layer_eager_ms": eager_ms(
             lambda: MoE.apply(p, x, cfg, capacity_factor=None), iters=10)}
    drive(cfg, params, dev, make_requests(cfg, (17,), 2), topology=topo,
          device=None, host_cache_mb=0)
    with RouteLog() as routes:
        got, m, wall, launches, _, _ = drive(
            cfg, params, dev, make_requests(cfg, PROMPT_LENS[:2], 12),
            topology=topo, device=None, host_cache_mb=0)
    c.update(served=served(got), metrics=m, wall_s=wall, launches=launches,
             ms_per_token=wall / m["tokens_generated"] * 1e3,
             # plain lists: a tensor would cross the queue as shared
             # memory, which dies with this process
             routes={r.uid: {q: v.tolist() for q, v in routes.routes(
                 r.seq_id, r.result).items()} for r in got.values()},
             seconds=time.perf_counter() - t0)
    out["c"] = c
    del params
    torch.cuda.empty_cache()
    return out


class _KeptRoutes:
    """A rank's ``RouteLog.routes`` results, by sequence."""

    def __init__(self, by_seq):
        import torch
        self.by_seq = {seq: {q: torch.tensor(v) for q, v in kept.items()}
                       for seq, kept in by_seq.items()}

    def routes(self, seq, stream):
        return self.by_seq[seq]


def model_axis_before(dev):
    """Phase 23's part before its ranks start: model 1 on this process
    alone (phase 18's 8 requests at W = 8, profiled) and the ranks'
    durable directory, a temporary one under ``build/``."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=TP_LAYERS)
    params = TransformerLM.init(cfg, seed=0, device=dev)
    fixed = dict(adaptive=False, host_cache_mb=0, rounds_per_sync=8)
    drive(cfg, params, dev, make_requests(cfg, (17,), 2), **fixed)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got1, m1, wall1, l1, _, _ = drive(
            cfg, params, dev, make_requests(cfg, PROMPT_LENS * 2,
                                            NEW_TOKENS), **fixed)
    busy1 = device_busy_s(prof)
    one = {"metrics": m1, "wall_s": wall1, "launches": l1,
           "ms_per_token": wall1 / m1["tokens_generated"] * 1e3,
           "device_busy_s": busy1, "idle_share": 1 - busy1 / wall1}
    torch.cuda.synchronize()
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="model-axis-durable-", dir=ROOT / "build")
    return {"cfg": cfg, "params": params, "one": one, "got1": got1,
            "durable_root": root, "before_s": time.perf_counter() - t0}


def model_axis_after(dev, tol, pre, ranks):
    """Phase 23: the model axis. Two model ranks (``collectives.spawn``,
    ``model_axis_rank``) share this card over gloo, which stages every
    collective through the host; ``ranks`` are their readings. (a)
    qwen3-1.7b at full width, its first ``TP_LAYERS`` layers, bf16, data
    1 x model 2: each rank's window logits against the whole
    model's within ``TP_LOGITS_TOL`` (max-abs), which every planted fault
    (``planted_faults``) must exceed, the collectives of one verify pass
    (layers x (4 + 1) all-reduces + 1 for the embedding, 1 logits gather),
    phase 18's 8 requests at W = 8 with tokens bitwise across the ranks
    and under the margin rule (``TP_LOGITS_TOL``) against model 1 (this
    process, alone on the card before the ranks start), ms per token and
    idle share of both;
    (b) data 2 x model 2 on the reference's TP traffic bitwise data 1 x
    model 2 at the same rows a call, and a preemption plus a cross-shard
    migration bitwise the undisturbed run; (c) the dbrx-132b cut at 2
    (attn, moe) layers, 8 experts a rank: ``_moe_ep_only`` against
    ``MoE.apply`` on the whole layer, the layer's eager ms on each rank
    against the whole layer's here, and two requests served with the
    routing logged, held against the solo sampler as phase 13 holds
    them (margin rule, ``tol``). (a)'s served run is durable; (d) restores
    a copy of its directory taken mid-run and must end with (a)'s tokens
    bitwise; (e) decides a deadline and ``max_request_seconds`` alike on
    both ranks, rank 1's clock skewed."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine.agreement import check_token_agreement
    from repro_torch.models.moe import MoE
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.admission import Request
    cfg, params, one, got1 = (pre["cfg"], pre["params"], pre["one"],
                              pre["got1"])
    m1 = one["metrics"]
    shutil.rmtree(pre["durable_root"], ignore_errors=True)
    out = {"model1": one, "ranks_s": pre["ranks_s"],
           "backend": ranks[0]["backend"]}
    r0, r1 = ranks
    out["rank_seconds"] = {k: r0[k]["seconds"]
                           for k in ("a", "b", "c", "d", "e")}
    log(f"phase 23: 2 model ranks on one card over {out['backend']}, "
        f"{out['ranks_s']:.1f} s in the ranks (rank 0's parts: "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in
                    out["rank_seconds"].items()) + ")")

    # (a)
    a0, a1 = r0["a"], r1["a"]
    if a0["served"] != a1["served"]:
        raise AssertionError("phase 23 (a): the ranks' tokens differ")
    model = a0["census"].get("model", {})
    want = {"all-reduce": cfg.n_layers * 5 + 1, "all-gather": 1}
    found = {k: model.get(k, {}).get("count", 0) for k in want}
    if found != want or set(a0["census"]) != {"model"}:
        raise AssertionError(f"phase 23 (a): collectives per pass "
                             f"{a0['census']}, want {want} on the model "
                             "axis")
    for r in (a0, a1):
        if not r["logits_max_abs_err"] < TP_LOGITS_TOL:
            raise AssertionError(f"phase 23 (a): window logits at model 2 "
                                 f"{r['logits_max_abs_err']} from model "
                                 f"1's, tolerance {TP_LOGITS_TOL}")
        passes = r["metrics"]["verify_passes"] + r["metrics"]["prefill_calls"]
        if not (r["launches"]["paged_decode"] == cfg.n_layers * passes
                and r["launches"]["spec_verify"] > 0):
            raise AssertionError(f"phase 23 (a): kernel path not taken "
                                 f"({passes} passes): {r['launches']}")
    for r in (a0, a1):
        fl = r["fallback_launches"]
        if not (fl["paged_write"] == 2 * cfg.n_layers * r["fallback_passes"]
                and fl["paged_decode"] == 0 and fl["spec_verify"] > 0):
            raise AssertionError(f"phase 23 (a): fallback path not taken: "
                                 f"{fl}")
    if a0["fallback_served"] != a1["fallback_served"]:
        raise AssertionError("phase 23 (a): the ranks' fallback tokens "
                             "differ")
    lens = PROMPT_LENS * 2
    ref1 = {u: r.result for u, r in got1.items()}
    splits = {}
    for s in a0["served"]:
        u = s["uid"]
        splits[u] = check_token_agreement(
            ref1[u], np.asarray(s["result"]),
            margin_fn(cfg, params, dev, ref1[u], u), TP_LOGITS_TOL,
            start=lens[u])
    a = {k: a0[k] for k in ("logits_max_abs_err", "argmax_equal",
                            "argmax_of", "census", "census_launches",
                            "metrics", "wall_s", "ms_per_token",
                            "device_busy_s", "idle_share", "param_gb",
                            "setup_s")}
    faults = {k: min(a0["faults"][k], a1["faults"][k]) for k in a0["faults"]}
    a.update(faults=faults,
             launches_by_rank=[a0["launches"], a1["launches"]],
             fallback_launches_by_rank=[a0["fallback_launches"],
                                        a1["fallback_launches"]],
             logits_err_by_rank=[a0["logits_max_abs_err"],
                                 a1["logits_max_abs_err"]],
             ms_per_token_by_rank=[a0["ms_per_token"], a1["ms_per_token"]],
             splits_vs_model1=splits)
    out["a"] = a
    per_pass = {k: model[k] for k in want}
    log(f"phase 23 (a) qwen3-1.7b data 1 x model 2: window logits within "
        f"{max(a['logits_err_by_rank']):.4g} of model 1's (max-abs, "
        f"tolerance {TP_LOGITS_TOL}; argmax equal at {a0['argmax_equal']} "
        f"of {a0['argmax_of']}); collectives per verify pass {per_pass} "
        f"(design: {want}); ranks' tokens bitwise (8 of 8); against model "
        f"1 (margin rule, tolerance {TP_LOGITS_TOL}): " + ", ".join(
            f"request {u} " + ("equal" if s is None else
                               f"split at {s['position']} (margin "
                               f"{s['margin']:.4g})")
            for u, s in splits.items()))
    log(f"phase 23 (a): model 2 {a['ms_per_token']:.3f} ms per token "
        f"(rank 1 {a1['ms_per_token']:.3f}), idle share "
        f"{a['idle_share']:.4f}, {a['metrics']['verify_passes']} verify "
        f"passes; model 1 {one['ms_per_token']:.3f} ms per token, idle "
        f"share {one['idle_share']:.4f}, {m1['verify_passes']} passes; "
        f"launches rank 0 {a0['launches']}, rank 1 {a1['launches']}")
    log("phase 23 (a): planted faults, window logits max-abs from model "
        "1's (the lesser of the ranks'): " + ", ".join(
            f"{k} {v:.4g}" for k, v in faults.items()))
    caught = min(faults.values())
    if not max(a["logits_err_by_rank"]) < TP_LOGITS_TOL < caught:
        raise AssertionError(f"phase 23 (a): tolerance {TP_LOGITS_TOL} does "
                             f"not part the sound reading "
                             f"{max(a['logits_err_by_rank'])} from the "
                             f"planted faults' least, {caught}")
    # (a) durable: rank 0 journals and checkpoints at every host sync
    syncs = a0["metrics"]["host_syncs"]
    if not (a0["metrics"].get("journal_appends", 0) > 0
            and "journal_appends" not in a1["metrics"]
            and a0["metrics"]["checkpoints_written"] == syncs
            and a1["metrics"]["checkpoints_written"] == 0
            and a0["fsync"]["n"] == a0["metrics"]["journal_syncs"]
            and a0["checkpoint"]["n"] == syncs):
        raise AssertionError(f"phase 23 (a): durability's counters: "
                             f"rank 0 {a0['metrics']}, rank 1 "
                             f"{a1['metrics']}, fsync {a0['fsync']}, "
                             f"checkpoint {a0['checkpoint']}")
    a.update(fsync=a0["fsync"], checkpoint=a0["checkpoint"],
             snapshot=a0["snapshot"])
    log(f"phase 23 (a) durable: rank 0 journal "
        f"{a0['metrics']['journal_appends']} records; {a0['fsync']['n']} "
        f"fsyncs {a0['fsync']['mean_ms']:.3f} ms mean "
        f"({a0['fsync']['max_ms']:.3f} max), {syncs} checkpoints "
        f"{a0['checkpoint']['mean_ms']:.3f} ms mean "
        f"({a0['checkpoint']['max_ms']:.3f} max, the ranks' agreement "
        f"included); copied for (d) after host sync "
        f"{a0['snapshot'].get('sync')} with {a0['snapshot'].get('done')} of 8 "
        "done")

    # (d)
    d0, d1 = r0["d"], r1["d"]
    snap = a0["snapshot"]
    if not (snap and snap == a1["snapshot"] and snap["done"] < 8):
        raise AssertionError(f"phase 23 (d): no mid-run copy: {snap}, "
                             f"{a1['snapshot']}")
    for r in (d0, d1):
        if r["served"] != a0["served"]:
            raise AssertionError("phase 23 (d): the restored run's tokens "
                                 "differ from (a)'s")
        if not (r["recovered"] >= 1 and r["recovered"] + r["redelivered"]
                == 8):
            raise AssertionError(f"phase 23 (d): recovered "
                                 f"{r['recovered']}, re-delivered "
                                 f"{r['redelivered']}")
        need_path(r["launches"], "phase 23 (d)")
    out["d"] = {k: [d0[k], d1[k]] for k in ("restore_ms", "recovered",
                                             "redelivered", "wall_s",
                                             "seconds")}
    out["d"]["metrics"] = d0["metrics"]
    log(f"phase 23 (d) restore over (a)'s copy: {d0['recovered']} requests "
        f"recovered, {d0['redelivered']} finishes re-delivered; restore "
        f"{d0['restore_ms']:.3f} / {d1['restore_ms']:.3f} ms on ranks 0 / 1 "
        f"(the journal's replay, the checkpoint and their broadcast, the "
        f"disk names' exchange, the agreement); the drain "
        f"{d0['wall_s']:.2f} s; all 8 requests bitwise (a)'s on both ranks")

    # (e)
    e0, e1 = r0["e"], r1["e"]
    if e0["outcomes"] != e1["outcomes"]:
        raise AssertionError(f"phase 23 (e): the ranks decided otherwise: "
                             f"{e0['outcomes']} / {e1['outcomes']}")
    oc = e0["outcomes"]
    if not (oc[0]["error"] == "timeout" and oc[1]["missed_deadline"]
            and oc[1]["error"] is None):
        raise AssertionError(f"phase 23 (e): want request 0 cut by "
                             f"max_request_seconds and request 1 past its "
                             f"deadline: {oc}")
    need_path(e0["launches"], "phase 23 (e)")
    out["e"] = {"outcomes": {u: {k: v for k, v in o.items() if k != "result"}
                             for u, o in oc.items()},
                "metrics": e0["metrics"], "seconds": e0["seconds"]}
    log(f"phase 23 (e) rank 1's clock 1000 + 7 t: both ranks cut request 0 "
        f"at {CLOCK_MAX_S} s (max_request_seconds), request 1 missed its "
        f"{CLOCK_DEADLINE_S} s deadline, the same tokens, no divergence; "
        + json.dumps(out["e"]["outcomes"]))

    # (b)
    b0, b1 = r0["b"], r1["b"]
    for label in ("data2_b4", "data1_b2", "migrated"):
        if b0[label]["served"] != b1[label]["served"]:
            raise AssertionError(f"phase 23 (b) {label}: the ranks differ")
        need_path(b0[label]["launches"], f"phase 23 (b) {label}")
    if b0["data2_b4"]["served"] != b0["data1_b2"]["served"]:
        raise AssertionError("phase 23 (b): data 2 x model 2 differs from "
                             "data 1 x model 2 at batch 2")
    mig = b0["migrated"]
    if not (mig["metrics"]["migrations"] == 1
            and mig["served"] == b0["data2_b4"]["served"]):
        raise AssertionError(f"phase 23 (b): migrations "
                             f"{mig['metrics']['migrations']}, tokens "
                             "differ from the undisturbed run")
    out["b"] = {"seconds": b0["seconds"], "migrate": b0["migrate"],
                "resume": mig["resume"],
                "metrics": {k: b0[k]["metrics"] for k in
                            ("data2_b4", "data1_b2", "migrated")}}
    moves = ", ".join(f"{g['blocks']} blocks in {g['ms']:.3f} ms"
                      for g in b0["migrate"])
    log(f"phase 23 (b) data 2 x model 2: tokens bitwise data 1 x model 2 "
        f"at batch 2 (4 of 4) and across the ranks; a preemption and a "
        f"cross-shard migration ({moves}) bitwise the undisturbed run; "
        f"{b0['seconds']:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c)
    c0, c1 = r0["c"], r1["c"]
    if c0["served"] != c1["served"]:
        raise AssertionError("phase 23 (c): the ranks' tokens differ")
    for r in (c0, c1):
        if not r["moe_within"]:
            raise AssertionError(f"phase 23 (c): _moe_ep_only "
                                 f"{r['moe_max_abs_err']} from MoE.apply "
                                 "in bf16, past one ulp")
        passes = r["metrics"]["verify_passes"] + r["metrics"]["prefill_calls"]
        if not (r["launches"]["paged_decode"] == DBRX_EP_LAYERS * passes
                and r["launches"]["spec_verify"] > 0):
            raise AssertionError(f"phase 23 (c): kernel path not taken: "
                                 f"{r['launches']}")
    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              n_layers=DBRX_EP_LAYERS)
    params = TransformerLM.init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn((2, 8, cfg.d_model), generator=gen,
                    device=dev).to(cfg.param_dtype)
    p = params["layers"][0]["ffn"]
    single_ms = eager_ms(lambda: MoE.apply(p, x, cfg, capacity_factor=None),
                         iters=10)
    p32 = {"router": {"w": p["router"]["w"].float()},
           "experts": {k: v.float() for k, v in p["experts"].items()}}
    y32, _ = MoE.apply(p32, x.float(), cfg, capacity_factor=None)
    del p32
    torch.cuda.empty_cache()
    err32 = [float((torch.tensor(r["y_ep_float32"], device=dev) - y32)
                   .abs().max()) for r in (c0, c1)]
    if not max(err32) < 2e-4:
        raise AssertionError(f"phase 23 (c): _moe_ep_only in float32 "
                             f"{err32} from MoE.apply, bound 2e-4")
    done = []
    for s in c0["served"]:
        r = Request(uid=s["uid"], prompt=np.asarray(s["prompt"]),
                    new_tokens=s["new_tokens"])
        r.result = np.asarray(s["result"])
        done.append(r)
    log(f"solo agreement, {cfg.name} {DBRX_EP_LAYERS}L at model 2 (margin "
        f"rule, tolerance {tol}, solo on decode_attention, the served "
        "routing from rank 0):")
    agreement = solo_agreement(
        cfg, params, dev, done, tol,
        routes=_KeptRoutes({r.seq_id: c0["routes"][r.uid] for r in done}),
        use_attention_kernel=True)
    out["c"] = {"experts_local": c0["experts_local"],
                "moe_max_abs_err": [c0["moe_max_abs_err"],
                                    c1["moe_max_abs_err"]],
                "moe_max_abs_err_float32": err32,
                "moe_layer_eager_ms_by_rank": [c0["moe_layer_eager_ms"],
                                               c1["moe_layer_eager_ms"]],
                "moe_layer_eager_ms_single": single_ms,
                "ms_per_token": c0["ms_per_token"], "metrics": c0["metrics"],
                "launches": c0["launches"], "agreement": agreement}
    log(f"phase 23 (c) {cfg.name} {DBRX_EP_LAYERS}L expert-parallel, "
        f"{c0['experts_local']} experts a rank: _moe_ep_only within "
        f"{max(err32):.4g} of MoE.apply in float32 (bound 2e-4), "
        f"{max(out['c']['moe_max_abs_err']):.4g} in bf16 (bound one bf16 "
        f"ulp, 2^-7 |y|); MoE layer eager {c0['moe_layer_eager_ms']:.3f} / "
        f"{c1['moe_layer_eager_ms']:.3f} ms on ranks 0 / 1 against "
        f"{single_ms:.3f} ms whole; served {c0['ms_per_token']:.3f} ms per "
        f"token, ranks' tokens bitwise; launches {c0['launches']}")
    del params, p, x
    pre.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 24: the model axis for training -------------------------------

TRAIN_MESH = dict(layers=14, B=2, S=2048, steps=2, moe_B=2, moe_T=256)
# the leaves whose step-1 gradients each rank gathers whole and holds
# against the single-device step's
TRAIN_NAMED = {"layer 0 wq": ("layers", 0, "mixer", "wq", "w"),
               "last layer ffn/down": ("layers", -1, "ffn", "down", "w"),
               "layer 0 norm1/scale": ("layers", 0, "norm1", "scale"),
               "final_norm/scale": ("final_norm", "scale")}
# (a) and (b)'s step-1 gate: the loss, the global norm and each named
# leaf's gradient, each as |difference| over the single-device value's
# (max-abs for a leaf). Set as TP_LOGITS_TOL is set: the geometric mean,
# rounded down, of the sound reading (0.02348, layer 0's wq at data 1 x
# model 2) and the least planted fault's (0.2406, the global norm counted
# per rank), both on an H100 (PERF.md); every run asserts it still parts
# the two
TRAIN_MESH_TOL = 0.075
# (c)'s limit: each compared tensor's max |difference| over its max |value|,
# two bf16 ulps of the largest value (each side rounds its float32 sums
# once; 0.00714 at most on an H100, the input's gradient)
MOE_TRAIN_TOL = 2 ** -6
MOE_TRAIN_AUX = 1.0        # the aux's weight in (c)'s loss


class _NoBackwardSum:
    """An axis whose all-reduce does nothing in a backward (grad mode is
    off there): ``copy_to``'s backward on it keeps each rank's partial
    gradient (a planted fault)."""

    def __init__(self, axis):
        self._axis = axis

    def __getattr__(self, name):
        return getattr(self._axis, name)

    def all_reduce(self, t):
        import torch
        return self._axis.all_reduce(t) if torch.is_grad_enabled() else t


class _OwnSlice:
    """An axis whose reduce-scatter keeps this rank's slice of its own
    gradient, unsummed: ``fsdp_gather``'s backward without the sum (a
    planted fault)."""

    def __init__(self, axis):
        self._axis = axis

    def __getattr__(self, name):
        return getattr(self._axis, name)

    def reduce_scatter(self, t, dim):
        n = t.shape[dim] // self._axis.size
        return t.narrow(dim, self._axis.rank * n, n).contiguous()


def replace_axis(leaves, name, wrap):
    """Put ``wrap(axis)`` in place of each leaf's placement axis ``name``;
    returns what to restore (``restore_axes``)."""
    from repro_torch.sharding import tensor_parallel as tp
    kept = []
    for t in leaves:
        pls = tp.placements_of(t)
        if name in pls:
            kept.append((t, pls))
            pl = pls[name]
            setattr(t, tp._ATTR, {**pls, name: tp.Placement(
                wrap(pl.axis), pl.dim, pl.shape)})
    return kept


def restore_axes(kept):
    from repro_torch.sharding import tensor_parallel as tp
    for t, pls in kept:
        setattr(t, tp._ATTR, pls)


def local_norm(grads):
    """The global norm counted on each rank's own slices (a planted
    fault: no all-reduce of the partial sums)."""
    import torch
    from repro_torch.optim.optimizers import tree_leaves
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


# the planted faults, each made alike on every rank, and the layouts
# (data, model) that can show them
TRAIN_FAULTS = {
    "copy_to backward left out (last layer's wq, wk, wv)":
        lambda d, m: m > 1,
    "data mean's all-reduce left out (leaves not split over data)":
        lambda d, m: d > 1,
    "fsdp_gather backward keeps its own slice": lambda d, m: d > 1,
    "global norm counted per rank": lambda d, m: True,
}


def plant_fault(fault, params, axis):
    """Plant ``fault`` (of ``TRAIN_FAULTS``, or None) on the placed
    ``params`` where it lives in their placements (the other faults live
    in the step's calls); returns what ``restore_axes`` restores. ``axis``
    is the batch's axis."""
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.sharding.collectives import JOINT
    if fault is not None and fault.startswith("copy_to"):
        mix = params["layers"][-1]["mixer"]
        return replace_axis([mix[k]["w"] for k in ("wq", "wk", "wv")],
                            "model", _NoBackwardSum)
    if fault is not None and fault.startswith("fsdp"):
        return replace_axis(tree_leaves(params),
                            JOINT if axis.name == JOINT else "data",
                            _OwnSlice)
    return []


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def named_grads(g):
    """The ``TRAIN_NAMED`` leaves of a placed gradient tree, gathered whole
    (every rank calls it), as float32 numpy arrays."""
    from repro_torch.sharding import tensor_parallel as tp
    return {k: tp.whole(_leaf(g, p)).float().cpu().numpy()
            for k, p in TRAIN_NAMED.items()}


def mesh_step_grads(step, params, batch, axis, faults, gather=named_grads):
    """Step 1's loss, global norm and ``gather`` of its gradient (the named
    leaves whole, float32, on the host), sound (key None) and under each
    of ``faults`` (``TRAIN_FAULTS``): the data mean's all-reduce left out
    and the per-rank norm read the sound step's gradient (before
    ``sync_grads``, the 1 / D loss scale kept; or its slices' norm);
    the copy_to and FSDP faults take the step again, planted
    (``plant_fault``). Returns them and the sound step's flash launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import train

    def reading(loss, g, norm=train.global_norm):
        with torch.no_grad():
            got = gather(g)
        return loss, float(norm(g)), got
    kernels.reset_launches()
    m, g = step.local_grads(params, batch)
    launches = kernels.LAUNCHES["flash_attention"]
    loss = float(train._mean_metrics(m, axis)["loss"])
    synced = train.sync_grads(g, axis)
    out = {None: reading(loss, synced)}
    for f in faults:
        if f.startswith("data mean's all-reduce"):
            out[f] = reading(loss, g)
        elif f == "global norm counted per rank":
            out[f] = reading(loss, synced, local_norm)
    del g, synced
    for f in faults:
        if f in out:
            continue
        kept = plant_fault(f, params, axis)
        try:
            m, g = step.local_grads(params, batch)
        finally:
            restore_axes(kept)
        out[f] = reading(float(train._mean_metrics(m, axis)["loss"]),
                         train.sync_grads(g, axis))
        del g
    return out, launches


def mesh_gate(got, base):
    """Each quantity of step 1 as |difference| over the single-device
    value's: the loss, the norm, each named leaf (max-abs)."""
    import numpy as np
    loss, gn, named = got
    out = {"loss": abs(loss - base["loss"]) / abs(base["loss"]),
           "grad_norm": abs(gn - base["grad_norm"]) / base["grad_norm"]}
    for k, v in named.items():
        w = base["named"][k]
        out[k] = float(np.abs(v - w).max() / np.abs(w).max())
    return out


def train_mesh_layout(cfg, axes, base, dev, spec):
    """One layout of phase 24 on this rank: the model placed
    (``place_train_params``), step 1's gate quantities sound and under each
    fault the layout can show, then ``spec["steps"]`` AdamW steps timed,
    the replicated leaves agreed bitwise after each; the collectives a
    step by axis, peak memory, flash launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import ShardedTokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import train
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding import collectives
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.collectives import JOINT
    t0 = time.perf_counter()
    full = TransformerLM.init(cfg, seed=0, device=dev)
    params = tp.place_train_params(cfg, full, axes)
    del full
    torch.cuda.empty_cache()
    d, m = axes["data"].size, axes["model"].size
    out = {"data": d, "model": m, "setup_s": time.perf_counter() - t0,
           "param_gb": torch.cuda.memory_allocated() / 1e9}
    opt = train.make_optimizer(cfg, steps=spec["steps"])
    state = opt.init(params)
    step = train.shard_train_step(cfg, opt, axes, remat=True, no_tp=False)
    axis = train.batch_axis(axes)
    B, S = spec["B"], spec["S"]
    pipe = ShardedTokenPipeline(token_batches(max(512, B * 8), B, S,
                                              cfg.vocab), dev, axis,
                                step.accum_steps)
    batches = [next(pipe) for _ in range(spec["steps"])]
    faults = [f for f, shows in TRAIN_FAULTS.items() if shows(d, m)]
    got, out["grads_flash_launches"] = mesh_step_grads(
        step, params, batches[0], axis, faults)
    out["sound"] = mesh_gate(got.pop(None), base)
    out["faults"] = {f: mesh_gate(v, base) for f, v in got.items()}
    rows = []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        before = {k: tuple(v) for k, v in collectives.STATS.items()}
        t1 = time.perf_counter()
        params, state, mt = step(params, state, b)
        loss = float(mt["loss"])            # reads the value: synchronizes
        ms = (time.perf_counter() - t1) * 1e3
        rows.append({"loss": loss, "grad_norm": float(mt["grad_norm"]),
                     "ms": ms, "tokens_per_s": B * S / ms * 1e3,
                     "peak_memory_gb": torch.cuda.max_memory_allocated()
                                       / 1e9,
                     "flash_launches": kernels.LAUNCHES["flash_attention"],
                     "collectives": collectives.stats_by_axis(before)})
        tp.agree_replicas(params, {JOINT: axes[JOINT]},
                          f"phase 24 ({d}, {m}) step {i + 1}")
    out["steps"] = rows
    if m > 1:
        # the logits gather alone: this rank's (B / D, S, V / M) slice
        x = torch.zeros((B // d, S, cfg.vocab // m), dtype=cfg.param_dtype,
                        device=dev)
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = axes["model"].all_gather(x, dim=-1)
            float(y[0, 0, 0])
            ms.append((time.perf_counter() - t1) * 1e3)
        out["logits_gather"] = {"bytes": y.numel() * y.element_size(),
                                "ms": ms}
        del x, y
    out["seconds"] = time.perf_counter() - t0
    del params, state
    torch.cuda.empty_cache()
    return out


def moe_train_check(cfg, axes, dev, spec):
    """(c): the MoE layer of the dbrx-132b cut, placed at data 1 x model 2
    (``place_train_params``: E / 2 experts a rank), one forward and
    backward at capacity 1.25 and one Adafactor step, against the whole
    layer's autograd and Adafactor step made on this rank from the same
    seed (each rank's slice of the whole results compared, and the input's
    and the router's gradients whole). The ranks take the whole layer's
    turn one after the other: its float32 Adafactor transients (~20 GB)
    would not fit twice beside the rest."""
    import torch
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.models.moe import MoE
    from repro_torch.optim.optimizers import tree_leaves, tree_map, \
        tree_unflatten
    from repro_torch.sharding import tensor_parallel as tp
    model = axes["model"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(24)
    whole = MoE.init(gen, cfg, dtype=cfg.param_dtype, device=dev)
    tree = {"layers": [{"ffn": whole}]}
    # a leaf no axis splits comes back as itself: copied, so that the two
    # steps below update two routers
    placed = tree_map(lambda t: t if tp.placements_of(t) else t.clone(),
                      tp.place_train_params(cfg, tree, axes)
                      ["layers"][0]["ffn"])
    x = torch.randn((spec["moe_B"], spec["moe_T"], cfg.d_model),
                    generator=gen, device=dev).to(cfg.param_dtype)
    r = torch.randn(x.shape, generator=gen, device=dev)

    def grads_of(p):
        p = tree_map(lambda t: tp.carry(t, t.detach().requires_grad_(True)),
                     p)
        xr = x.detach().requires_grad_(True)
        y, aux = MoE.apply(p, xr, cfg, capacity_factor=1.25)
        loss = (y.float() * r).sum() + MOE_TRAIN_AUX * aux
        gl = torch.autograd.grad(loss, [xr] + tree_leaves(p))
        return (y.detach(), float(aux.detach()), gl[0],
                tree_map(tp.carry, p, tree_unflatten(p, list(gl[1:]))))

    def timed(fn, *a):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = fn(*a)
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t1) * 1e3

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())
    (y, aux, gx, g), placed_ms = timed(grads_of, placed)
    opt = optim.adafactor(1e-3)
    state = opt.init(placed)
    opt.step(g, state, placed)
    e_loc = placed["experts"]["up"].shape[0]
    sl = slice(model.rank * e_loc, (model.rank + 1) * e_loc)
    errs = {}
    for turn in range(model.size):
        if turn == model.rank:
            (wy, waux, wgx, wg), whole_ms = timed(grads_of, whole)
            errs.update({"y": rel(y, wy), "grad x": rel(gx, wgx),
                         "grad router": rel(g["router"]["w"],
                                            wg["router"]["w"])})
            for k in placed["experts"]:
                errs[f"grad experts/{k}"] = rel(g["experts"][k],
                                                wg["experts"][k][sl])
            del g, wy, wgx
            wstate = opt.init(whole)
            opt.step(wg, wstate, whole)
            del wg
            for k in placed["experts"]:
                errs[f"experts/{k} after the step"] = rel(
                    placed["experts"][k], whole["experts"][k][sl])
                for f in ("vr", "vc"):
                    errs[f"{f} of experts/{k}"] = rel(
                        state["v"]["experts"][k][f],
                        wstate["v"]["experts"][k][f][sl])
            errs["router after the step"] = rel(placed["router"]["w"],
                                                whole["router"]["w"])
            del wstate, whole
            torch.cuda.empty_cache()
        if model.size > 1:
            dist.barrier(group=model.group)
    out = {"experts_local": int(e_loc), "aux": aux, "aux_whole": waux,
           "errs": errs, "fwd_bwd_ms": placed_ms,
           "whole_fwd_bwd_ms": whole_ms,
           "seconds": time.perf_counter() - t0}
    del placed, state
    torch.cuda.empty_cache()
    return out


def train_mesh_rank(rank, base):
    """Phase 24's rank ``rank`` of 2, run by ``axis_ranks`` after phase
    23's part, in the same process group on the same card (gloo): (a) the
    qwen3-1.7b cut at data 1 x model 2, (b) at data 2 x model 1 (a second
    layout's groups in the same world), (c) the dbrx-132b cut's MoE layer
    at data 1 x model 2, each sized by ``TRAIN_MESH``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.sharding import collectives
    spec = TRAIN_MESH
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=spec["layers"])
    axes = collectives.layout_axes(2, "gloo", dev)
    out = {"rank": rank, "backend": axes["model"].backend}

    def part(key, fn, *a):
        out[key] = fn(*a)
        # each part's readings as it ends, in case a later one fails
        log(f"phase 24 rank {rank} ({key}): "
            + json.dumps(out[key], default=str))
    part("a", train_mesh_layout, cfg, axes, base, dev, spec)
    part("b", train_mesh_layout, cfg,
         collectives.layout_axes(1, "gloo", dev), base, dev, spec)
    moe_cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=2)
    part("c", moe_train_check, moe_cfg, axes, dev, spec)
    return out


def train_mesh_baseline(cfg, dev, spec):
    """The single-device step from the same seed-0 parameters and batches:
    step 1's loss, global norm and named gradients (on the host), then
    ``spec["steps"]`` AdamW steps timed, their peak memory and flash
    launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import train
    from repro_torch.models.transformer import TransformerLM
    B, S = spec["B"], spec["S"]
    params = TransformerLM.init(cfg, seed=0, device=dev)
    opt = train.make_optimizer(cfg, steps=spec["steps"])
    state = opt.init(params)
    step = train.make_train_step(cfg, opt, remat=True)
    pipe = TokenPipeline(token_batches(max(512, B * 8), B, S, cfg.vocab),
                         dev)
    batches = [next(pipe) for _ in range(spec["steps"])]
    m, g = step.local_grads(params, batches[0])
    base = {"loss": float(m["loss"]),
            "grad_norm": float(train.global_norm(g)),
            "named": {k: _leaf(g, p).float().cpu().numpy()
                      for k, p in TRAIN_NAMED.items()}}
    del g
    rows = []
    for b in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t1 = time.perf_counter()
        params, state, mt = step(params, state, b)
        loss = float(mt["loss"])
        ms = (time.perf_counter() - t1) * 1e3
        rows.append({"loss": loss, "grad_norm": float(mt["grad_norm"]),
                     "ms": ms, "tokens_per_s": B * S / ms * 1e3,
                     "peak_memory_gb": torch.cuda.max_memory_allocated()
                                       / 1e9,
                     "flash_launches": kernels.LAUNCHES["flash_attention"]})
    del params, state
    torch.cuda.empty_cache()
    return base, rows


def gate_train_mesh(out, layers):
    """Phase 24's gates over the ranks' readings (``out["ranks"]``): (a)
    and (b) within ``TRAIN_MESH_TOL`` of the single-device step, which
    every planted fault exceeds; flash on its kernel route, 2 x layers
    launches a rank a step (the forward and the recompute); the ranks'
    losses equal; (c) within ``MOE_TRAIN_TOL``. Returns the sound reading
    and the least fault's."""
    sound, least = 0.0, float("inf")
    for r in out["ranks"]:
        for lay in ("a", "b"):
            x = r[lay]
            sound = max(sound, max(x["sound"].values()))
            for f, v in x["faults"].items():
                least = min(least, max(v.values()))
            want = 2 * layers
            got = {x["grads_flash_launches"]} | {s["flash_launches"]
                                                 for s in x["steps"]}
            if got != {want}:
                raise AssertionError(f"phase 24 ({lay}) rank {r['rank']}: "
                                     f"flash launches {got}, want {want} "
                                     "a step (forward and recompute)")
        bad = {k: v for k, v in r["c"]["errs"].items()
               if not v <= MOE_TRAIN_TOL}
        if bad:
            raise AssertionError(f"phase 24 (c) rank {r['rank']}: beyond "
                                 f"{MOE_TRAIN_TOL}: {bad}")
    r0, r1 = out["ranks"]
    for lay in ("a", "b"):
        if [s["loss"] for s in r0[lay]["steps"]] != \
                [s["loss"] for s in r1[lay]["steps"]]:
            raise AssertionError(f"phase 24 ({lay}): the ranks' logged "
                                 "losses differ")
    if not sound < TRAIN_MESH_TOL < least:
        raise AssertionError(f"phase 24: tolerance {TRAIN_MESH_TOL} does "
                             f"not part the sound reading {sound} from the "
                             f"planted faults' least, {least}")
    return sound, least


def train_mesh_before(dev):
    """Phase 24's part before its ranks start: the single-device baseline
    (``train_mesh_baseline``: the qwen3-1.7b cut to 14 layers, B = 2, S =
    2048, bf16, AdamW, ``remat=True``, phase 7's seed-0 parameters and
    ``token_batches``); the ranks' reference rides under ``base``."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=TRAIN_MESH["layers"])
    base, single = train_mesh_baseline(cfg, dev, TRAIN_MESH)
    out = {"single": single, "base_loss": base["loss"],
           "base_grad_norm": base["grad_norm"], "base": base,
           "layers": cfg.n_layers, "baseline_s": time.perf_counter() - t0}
    for i, row in enumerate(single):
        log(f"phase 24 single device step {i + 1}: loss {row['loss']:.6g}, "
            f"{row['ms']:.1f} ms, {row['tokens_per_s']:.1f} tokens/s, peak "
            f"{row['peak_memory_gb']} GB, flash launches "
            f"{row['flash_launches']}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def train_mesh_after(out, ranks):
    """Phase 24: the model axis for training. Two ranks
    (``train_mesh_rank``) sharing the card over gloo ran the baseline's
    step at data 1 x model 2 and data 2 x model 1, and the dbrx-132b cut's
    MoE layer expert-parallel; ``gate_train_mesh`` gates ``ranks``, their
    readings, here."""
    single = out["single"]
    out["ranks"] = ranks
    for r in out["ranks"]:
        for lay, name in (("a", "data 1 x model 2"),
                          ("b", "data 2 x model 1")):
            x = r[lay]
            log(f"phase 24 ({lay}) {name}, rank {r['rank']}: step 1 sound "
                + ", ".join(f"{k} {v:.4g}" for k, v in x["sound"].items()))
            for f, v in x["faults"].items():
                log(f"phase 24 ({lay}) rank {r['rank']}, planted {f}: "
                    + ", ".join(f"{k} {w:.4g}" for k, w in v.items()))
            for i, s in enumerate(x["steps"]):
                log(f"phase 24 ({lay}) rank {r['rank']} step {i + 1}: loss "
                    f"{s['loss']:.6g} (single device "
                    f"{single[i]['loss']:.6g}), {s['ms']:.1f} ms, "
                    f"{s['tokens_per_s']:.1f} tokens/s of the whole batch, "
                    f"peak {s['peak_memory_gb']} GB, flash launches "
                    f"{s['flash_launches']}, collectives "
                    f"{json.dumps(s['collectives'])}")
            if "logits_gather" in x:
                g = x["logits_gather"]
                log(f"phase 24 ({lay}) rank {r['rank']}: the logits gather "
                    f"alone, {g['bytes']} bytes, ms {g['ms']}")
        c = r["c"]
        log(f"phase 24 (c) rank {r['rank']}: {c['experts_local']} experts a "
            f"rank, aux {c['aux']:.6g} (whole {c['aux_whole']:.6g}), fwd+bwd "
            f"{c['fwd_bwd_ms']:.1f} ms (whole {c['whole_fwd_bwd_ms']:.1f}), "
            "rel errs " + ", ".join(f"{k} {v:.3g}"
                                    for k, v in c["errs"].items()))
    out["sound"], out["least_fault"] = gate_train_mesh(out, out["layers"])
    log(f"phase 24: step-1 gate within {out['sound']:.4g} of the single "
        f"device (tolerance {TRAIN_MESH_TOL}; the least planted fault "
        f"{out['least_fault']:.4g})")
    return out


def axis_ranks(rank, world, store_path, durable_root, base):
    """Model rank ``rank`` of 2 for phases 23 and 24 in one process group:
    ``model_axis_rank``'s parts, then ``train_mesh_rank``'s over the same
    world (its layouts' groups made anew). Returns both readings."""
    import torch
    out = {"p23": model_axis_rank(rank, world, store_path, durable_root)}
    torch.cuda.empty_cache()
    out["p24"] = train_mesh_rank(rank, base)
    return out


def model_axis_phases(dev, tol):
    """Phases 23 and 24 with one spawn of two ranks (``axis_ranks``),
    which saves one start of the ranks (their imports, the kernels' load,
    CUDA's context): each phase's part before its ranks, the ranks, then
    each phase's gates. Returns both phases' readings, the ranks' start
    and each phase's seconds (its own parts, and its ranks' part as rank 0
    timed it)."""
    from repro_torch.sharding import collectives
    t0 = time.perf_counter()
    pre23 = model_axis_before(dev)
    pre24 = train_mesh_before(dev)
    base = pre24.pop("base")
    t1 = time.perf_counter()
    ranks = collectives.spawn(axis_ranks, 2, pre23["durable_root"], base,
                              timeout=1500)
    ranks_s = time.perf_counter() - t1
    pre23["ranks_s"] = pre24["ranks_s"] = ranks_s
    t2 = time.perf_counter()
    p23 = model_axis_after(dev, tol, pre23, [r["p23"] for r in ranks])
    t3 = time.perf_counter()
    p24 = train_mesh_after(pre24, [r["p24"] for r in ranks])
    t4 = time.perf_counter()
    log(f"phases 23-24: {t4 - t0:.1f} s in all, {ranks_s:.1f} s in one "
        f"spawn of the ranks; before them 23 {pre23['before_s']:.1f} s, 24 "
        f"{pre24['baseline_s']:.1f} s; after them 23 {t3 - t2:.1f} s, 24 "
        f"{t4 - t3:.1f} s")
    return p23, p24, {"seconds": t4 - t0, "ranks_s": ranks_s,
                      "before_23_s": pre23["before_s"],
                      "before_24_s": pre24["baseline_s"],
                      "after_23_s": t3 - t2, "after_24_s": t4 - t3}


def recovery_child_main(mode, ddir, disk_tier) -> int:
    """``--recovery-child``: phase 20 (c)'s child on the card, (a)'s
    workload on a durable engine over ``ddir`` (two priority-5 requests,
    two priority-0 arrivals after the first sync)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=DURABLE_LAYERS)
    params = TransformerLM.init(cfg, seed=0, device=dev)
    kernels.reset_launches()
    recovery_child(
        lambda: ServingEngine(
            cfg, params, batch=2, window_max=8, block_size=16, max_len=256,
            eps_key=1, use_verify_kernel=True, adaptive=False,
            durable_dir=ddir, journal_fsync_every=1, disk_tier=disk_tier,
            device=dev),
        mode, shared_lows(cfg), shared_highs(cfg), CHILD_KEYS,
        extra=lambda: {"launches": dict(kernels.LAUNCHES)})
    return 0


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None,
                    help="write every number measured to this JSON file")
    ap.add_argument("--recovery-child", nargs=2, default=None,
                    metavar=("MODE", "DIR"),
                    help="instead of the phases: phase 20 (c)'s child, "
                    "'serve' or 'resume' over the durable directory DIR "
                    "(JSON events on stdout)")
    ap.add_argument("--no-disk-tier", action="store_true",
                    help="with --recovery-child: no disk tier")
    ap.add_argument("--mistral-depths", type=int, nargs="+", default=None,
                    metavar="LAYERS",
                    help="instead of the phases: build the kernels, run "
                    "phase 14 (c) (the mistral-large-123b cut served and "
                    "checked) at each of these depths, log its seconds, "
                    "and exit without the result lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.recovery_child:
        mode, ddir = args.recovery_child
        return recovery_child_main(mode, ddir, not args.no_disk_tier)
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
    report = {"gpu": smi, "phase_seconds": {}}
    mark = [time.perf_counter()]

    def lap(phase):
        """The seconds since the last lap, logged as ``phase``'s; the
        phase's engines, whose timing wrappers make reference cycles, are
        collected."""
        gc.collect()
        now = time.perf_counter()
        report["phase_seconds"][phase] = now - mark[0]
        log(f"phase {phase}: {now - mark[0]:.1f} s")
        mark[0] = now

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
    if args.mistral_depths:
        # at phase 5's tolerance, as phase 14 runs it
        report["mistral_depths"] = {
            n: serve_dense(dev, 0.25, "mistral-large-123b", n)[0]["seconds"]
            for n in args.mistral_depths}
        log("phase 14 (c) seconds by depth: "
            + json.dumps(report["mistral_depths"]))
        if args.report:
            path = Path(args.report)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(report, indent=1, default=str))
        return 0
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
    lap("2")

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
    lap("3")

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
    lap("4")

    # ---- phase 5: agreement with the solo sampler ------------------------
    # bf16 logits of magnitude ~1 after 28 layers; the fused kernel keeps
    # scores in float32 where the solo path's _sdpa rounds them to bf16, so
    # the two logit vectors differ by up to a few hundredths
    tol = 0.25
    log(f"solo agreement (margin rule, tolerance {tol}):")
    report["agreement"] = solo_agreement(cfg, params, dev, done, tol)
    del params
    torch.cuda.empty_cache()
    lap("5")

    # ---- phase 6: DeepSeek-V3's MLA layers at full width ------------------
    report["deepseek"], ds_launches = serve_deepseek(dev, tol)
    lap("6")

    # ---- phase 7: training qwen3-1.7b on the flash-attention kernel ------
    report["train"], tr_launches = train_qwen(dev)
    lap("7")

    # ---- phase 8: the forecast-KL objective on DeepSeek-V3 ---------------
    report["train_deepseek"] = train_deepseek(dev, tol)
    lap("8")

    # ---- phase 9: rwkv6-7b served at full width on the WKV kernel --------
    report["rwkv"], rw_launches = serve_rwkv(dev, get_config("rwkv6-7b"),
                                             tol)
    lap("9")

    # ---- phase 10: the solo sampler's dense cache on its kernel ----------
    report["solo_dense"], sd_launches = solo_dense(dev, cfg, done, tol)
    lap("10")

    # ---- phases 11-12: the samplers of Tables 1 and 2 at full width -----
    report["table1"] = table1(dev)
    lap("11")
    report["table2"] = table2(dev)
    lap("12")

    # ---- phase 13: the MoE layer, DeepSeek-V3 and dbrx-132b --------------
    t13 = time.perf_counter()
    report["moe_deepseek"], _ = serve_moe(
        dev, tol, "deepseek-v3-671b", MOE_SERVE_LAYERS["deepseek-v3-671b"],
        latent=True)
    report["moe_dbrx"], dbrx_launches = serve_moe(
        dev, tol, "dbrx-132b", MOE_SERVE_LAYERS["dbrx-132b"], latent=False)
    report["train_dbrx"], dbrx_train_launches = train_dbrx(dev)
    report["phase13_s"] = time.perf_counter() - t13
    lap("13")
    dbrx_solo = report["moe_dbrx"]["fpi"]["solo_launches"]

    # ---- phase 14: gemma3-1b, gemma-2b, a mistral-large-123b cut ---------
    t14 = time.perf_counter()
    dense = check_dense_kernels(dev, gen)
    report["dense_kernels"] = dense
    served = {}
    for key, arch in (("gemma3", "gemma3-1b"), ("gemma2b", "gemma-2b"),
                      ("mistral", "mistral-large-123b")):
        report["serve_" + key], *served[key] = serve_dense(
            dev, tol, arch, DENSE_LAYERS[arch])
    report["train_gemma3"], g3_train = train_gemma3(dev)
    report["phase14_s"] = time.perf_counter() - t14
    lap("14")

    # ---- phase 15: the Mamba mixer, a jamba-1.5-large-398b cut ----------
    report["serve_jamba"], *served["jamba"] = serve_jamba(dev, tol, gen)
    lap("15")

    # ---- phase 16: the multimodal backbones at head width 64 ------------
    report["frontends"] = frontends_phase(dev, tol, gen)
    lap("16")

    # ---- phase 17: fault isolation on phase 3's engine --------------------
    report["faults"] = fault_phase(dev, tol, phase3)
    lap("17")

    # ---- phase 18: the scheduler under saturation ------------------------
    report["saturation"] = saturation_phase(dev, tol, phase3)
    lap("18")

    # ---- phase 19: the host cache tier -----------------------------------
    report["host_tier"] = host_tier_phase(dev, tol, report["saturation"])
    lap("19")

    # ---- phase 20: crash-safe serving -------------------------------------
    report["durable"] = durable_phase(dev, tol)
    lap("20")

    # ---- phase 21: the hot-path checks and the launch layer ---------------
    report["hot_path"] = hot_path_phase(dev)
    lap("21")

    # ---- phase 22: the data-parallel mesh engine --------------------------
    report["mesh"] = mesh_phase(dev)
    lap("22")

    # ---- phases 23-24: the model axis, serving (tensor and expert
    # parallelism, durable, one clock) and training, in one spawn ----------
    (report["model_axis"], report["train_mesh"],
     report["model_axis_phases"]) = model_axis_phases(dev, tol)
    lap("23-24")
    log("seconds by phase: " + json.dumps(
        {k: round(v, 1) for k, v in report["phase_seconds"].items()}))

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
    # phase 23's path on each of its two model ranks (rank 0's counts)
    ax = report["model_axis"]["a"]
    for name, n, path in (
            ("spec_verify", ax["launches_by_rank"][0]["spec_verify"],
             "serve_model_axis"),
            ("paged_decode", ax["launches_by_rank"][0]["paged_decode"],
             "serve_model_axis"),
            ("paged_write", ax["fallback_launches_by_rank"][0]["paged_write"],
             "serve_model_axis_fallback")):
        entry = next(e for e in entries if e["name"] == name)
        entry["model_axis"] = {"launches": n, "path": path,
                               "ranks": 2}
    # phase 24's path: flash on each of the two training ranks, layout (a)'s
    # steps (rank 0's counts: every step's forward and recompute)
    ta = report["train_mesh"]["ranks"][0]["a"]
    entry = next(e for e in entries if e["name"] == "flash_attention")
    entry["train_mesh"] = {
        "launches": sum(s["flash_launches"] for s in ta["steps"]),
        "path": "train_model_axis", "ranks": 2}
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
