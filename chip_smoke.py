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
   plain version and one library call;
3. serve 4 requests of qwen3-1.7b through ``ServingEngine`` at full width
   (28 layers, bf16, random weights from a seed) on the kernel path, with
   the launch counts of that run and a profile of a shorter one;
4. a shorter qwen run on the gather fallback (``use_attention_kernel=
   False``), which is the path of the writeback kernel;
5. token agreement of phase 3's requests with the port's solo sampler under
   the margin rule;
6. DeepSeek-V3 at its published widths, cut to its three dense-prefix MLA
   layers (its MoE layers are not ported): the same 4 requests served on
   the latent kernel's path with fixed-point forecasts and again with the
   learned forecast (MTP) heads, a profile, one request on the gather
   fallback (the writeback kernel on both latent pools), and every request
   against the solo sampler under the margin rule.

The second line from the end is a JSON object with one entry per kernel;
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


def times(kernel, plain, library):
    """Device and eager milliseconds of a kernel, its plain version and
    the library yardstick."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key] = device_ms(fn)
        out["eager_" + key] = eager_ms(fn)
    return out


def bound(nbytes, nops, dtype):
    t_mem = nbytes / MEM_BYTES_PER_S
    t_ops = nops / PEAK_OPS[dtype]
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_spec_verify(dev, gen):
    import torch
    from repro_torch.kernels.spec_verify.ops import spec_verify
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    rows = {}
    # B * W at W = 8 and W = 16 over qwen3-1.7b's vocab, and W = 8 over
    # DeepSeek-V3's, which splits each row into other chunks
    for R, nv in ((16, V), (32, V), (16, V_DS)):
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


def _paged_inputs(dev, gen, B, W, nb, lengths, dtype):
    import torch
    P = 1 + B * nb + 3
    k_pool = torch.randn((P, BS, KV, D), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((P, BS, KV, D), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * nb] + 1
    tables = perm.reshape(B, nb).to(torch.int32)
    k_new = torch.randn((B, W, KV, D), generator=gen, device=dev).to(dtype)
    v_new = torch.randn((B, W, KV, D), generator=gen, device=dev).to(dtype)
    q = torch.randn((B, W, KV * G, D), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, k_new, v_new, tables, lens


def _visible_blocks(lengths, W, nb, window):
    total = 0
    for L in lengths:
        hi = min((L + W - 1) // BS, nb - 1)
        lo = max(0, L - window + 1) // BS if window > 0 else 0
        total += hi - lo + 1
    return total


def check_paged_decode(dev, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import (
        gather_view, paged_attention_fused_ref)
    nb = 17                                # (max_len 256 + W 8) / 16
    cases = [("verify", 2, 8, [100, 37], 0),      # a verify round
             ("prefill", 1, 64, [16], 0),         # a 64-wide prefill chunk
             ("verify_sliding", 2, 8, [200, 61], 32)]
    rows, worst = {}, 0.0
    for name, B, W, lengths, window in cases:
        ins = _paged_inputs(dev, gen, B, W, nb, lengths, torch.bfloat16)
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
        nbytes = (2 * cached * KV * D * 2
                  + 2 * q.numel() * 2
                  + 2 * 2 * k_new.numel() * 2
                  + nblk * 4 + B * 4)
        vis = sum(min(L + w + 1, window) if window else L + w + 1
                  for L in lengths for w in range(W))
        b_ms, b_by = bound(nbytes, 4 * G * KV * D * vis, "bfloat16")
        rows[name] = {
            "max_abs_err": float(err.max()), "bound_ms": b_ms,
            "bound_by": b_by,
            **times(lambda: paged_attention(q, kp1, vp1, k_new, v_new,
                                            tables, lens, window=window),
                    lambda: paged_attention_fused_ref(
                        q, kp2, vp2, k_new, v_new, tables, lens,
                        window=window),
                    lib)}
        log(f"paged_decode {name} B={B} W={W} lengths={lengths} "
            f"window={window}: pools bitwise (block 0 excluded); "
            f"{rows[name]}")
    return rows, worst


def check_paged_write(dev, gen):
    """The writeback kernel on qwen3-1.7b's K/V pool rows (8 kv heads of
    128) and on DeepSeek-V3's two latent pools (c_kv rows of 512 and k_rope
    rows of 64), bf16, at the verify and the prefill-chunk widths."""
    import torch
    from repro_torch.kernels.paged_attention.ops import paged_window_write
    from repro_torch.kernels.paged_attention.ref import write_window_paged
    nb = 17
    rows = {}
    verify, prefill = (2, 8, [100, 37], [1, 1]), (1, 64, [16], [1])
    for name, (B, W, lengths, active), row in (
            ("verify", verify, (KV, D)),
            ("prefill", prefill, (KV, D)),
            ("inactive_row", (2, 8, [30, 201], [1, 0]), (KV, D)),
            ("latent_c_kv_verify", verify, (R_LAT,)),
            ("latent_c_kv_prefill", prefill, (R_LAT,)),
            ("latent_k_rope_verify", verify, (DR,)),
            ("latent_k_rope_prefill", prefill, (DR,))):
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
    import torch
    import torch.nn.functional as F
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
        q_lat, q_rope = rn(B, W, H_MLA, R_LAT), rn(B, W, H_MLA, DR)
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
            "bound_ms": b_ms, "bound_by": b_by,
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


def serve(cfg, params, dev, reqs, **kw):
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
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
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


def profile_serve(cfg, params, dev):
    """Where the time of a short serving run on the kernel path goes (2
    requests, 16 new tokens each): the run once without the profiler for
    its wall time, then once under ``torch.profiler`` for the device busy
    time from its kernel records and the kernels that take the most. The
    idle share is taken against the unprofiled wall, since the profiler
    lengthens the host's time but not the kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = make_requests(cfg, PROMPT_LENS[:2], 16)
    _, m, wall, _ = serve(cfg, params, dev, reqs)
    reqs = make_requests(cfg, PROMPT_LENS[:2], 16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pm, pwall, _ = serve(cfg, params, dev, reqs)
    kern = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        kern.append((float(us), evt.count, evt.key))
    kern.sort(reverse=True)
    busy_s = sum(k[0] for k in kern) / 1e6
    # device time of each of the port's own kernels, by function name
    # (spec_verify's call runs spec_verify_partial and spec_verify_final)
    own = {}
    for name in ("spec_verify", "paged_decode", "paged_latent",
                 "paged_write"):
        hits = [(us, n) for us, n, key in kern if name + "_" in key]
        own[name] = {"us": sum(h[0] for h in hits),
                     "count": sum(h[1] for h in hits)}
    passes = m["rounds"] + m["prefill_calls"]
    out = {"wall_s": wall, "profiled_wall_s": pwall, "device_busy_s": busy_s,
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


def solo_agreement(cfg, params, dev, done, tol, **kw):
    """Each served request against the port's solo sampler (dense cache,
    plain attention, plain argmax: none of the port's kernels) on the
    card, under the margin rule; ``kw`` goes to
    the sampler (``use_forecast_heads``). Where the streams split within
    the tolerance, the solo sampler starts again from the engine's tokens
    up to and including that position (the noise depends only on the
    sequence and the position), so every new token is compared."""
    import torch
    from repro_torch.engine.agreement import (check_token_agreement,
                                              top2_margin)
    from repro_torch.engine.spec_decode import PredictiveSampler, make_eps_fn
    from repro_torch.models.transformer import TransformerLM
    eps_fn = make_eps_fn(1, cfg.vocab)
    out = []
    for r in sorted(done, key=lambda r: r.uid):
        end = len(r.prompt) + r.new_tokens
        start, splits = len(r.prompt), []
        while start < end:
            s = PredictiveSampler(cfg, params, window=8, max_len=256,
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
            res = check_token_agreement(ref, r.result, margin_at, tol,
                                        start=start)
            if res is None:
                break
            splits.append(res)
            start = res["position"] + 1
        out.append({"uid": r.uid, "equal": not splits,
                    "compared": r.new_tokens, "splits": splits})
        log(f"  request {r.uid}: {r.new_tokens} new tokens compared, "
            + ("equal to solo" if not splits else "split within tolerance "
               "at " + ", ".join(f"{d['position']} (reference margin "
                                 f"{d['margin']:.4g} < {tol})"
                                 for d in splits)))
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
    gen = torch.Generator(device=dev).manual_seed(0)
    sv = check_spec_verify(dev, gen)
    pd, pd_err = check_paged_decode(dev, gen)
    pw = check_paged_write(dev, gen)
    pl, pl_err = check_paged_latent(dev, gen)
    report["kernels_detail"] = {"spec_verify": sv, "paged_decode": pd,
                                "paged_write": pw, "paged_latent": pl}

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
    report["serve"] = {"metrics": m, "wall_s": wall, "launches": launches}
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

    entries = []
    for name, rows, key, n, path, extra in (
            ("spec_verify", sv, f"R16_V{V}", launches["spec_verify"],
             "serve", 0),
            ("paged_decode", pd, "verify", launches["paged_decode"], "serve",
             pd_err),
            ("paged_write", pw, "verify", fb_launches["paged_write"],
             "serve_gather_fallback", 0),
            ("paged_latent", pl, "verify", ds_launches["paged_latent"],
             "serve_deepseek", pl_err)):
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
                    "src/repro/kernels/paged_attention/kernel.py:248"}[name],
            "launches": n, "path": path,
            "max_abs_err": max(float(r["max_abs_err"]) for r in rows.values())
            if extra == 0 else extra,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "eager_ms": row["eager_ms"], "eager_plain_ms": row["eager_plain_ms"],
            "eager_library_ms": row["eager_library_ms"]})
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
