"""Serving launcher: predictive sampling through the port's paged serving
engine.

``python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced --requests 6``

Initializes random weights from a seed, submits ``--requests`` requests
with random prompts (the reference launcher's generator) and drains them
through ``ServingEngine``. Runs on the GPU unless ``--device cpu``.

Also exports ``make_serve_step``, the reference's one-round verify step
over a dense cache, with its two-pass low-memory form for recurrent and
hybrid stacks.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.reparam import reparam_argmax
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultPlan


def make_serve_step(cfg, window: int = 8, low_memory: bool = False,
                    use_kernel: bool = False):
    """One predictive-sampling verify round over a dense cache.

    ``serve_step(params, cand (B, W), cache, cache_len (B,), eps (B, W,
    V))`` returns (out tokens (B, W), accept (B,), new_cache), the
    recurrent states taken at ``accept``. ``low_memory`` is the
    reference's two-pass form for recurrent and hybrid stacks: pass 1
    computes the logits with no per-position states (``state_mode=
    "none"``), pass 2 recomputes the window with every recurrent update
    frozen past the accept point (``"advance"``): twice the decode's work
    for no (layers, B, W, state) stack. Both forms give the same tokens,
    accept counts and states (bitwise on the plain routes).
    ``use_kernel`` runs the mixers' kernels (``decode_window``)."""
    def serve_step(params, cand, cache, cache_len, eps):
        logits, _, new_cache = TransformerLM.decode_window(
            params, cfg, cand, cache, cache_len, use_kernel=use_kernel,
            state_mode="none" if low_memory else "per_position")
        out = reparam_argmax(logits.float(), eps)
        match = cand[:, 1:] == out[:, :-1]
        accept = 1 + torch.cumprod(match.long(), dim=1).sum(dim=1)
        if low_memory:
            _, _, adv = TransformerLM.decode_window(
                params, cfg, cand, cache, cache_len, use_kernel=use_kernel,
                state_mode="advance", accept=accept)
            return out, accept, adv
        return out, accept, TransformerLM.select_states(cfg, new_cache,
                                                        accept)

    return serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--window", type=int, default=8,
                    help="max verify window W (adaptive controller's bound)")
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV-cache block size (tokens per physical block)")
    ap.add_argument("--no-adaptive", action="store_true",
                    help="pin W instead of adapting it to acceptance")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--rounds-per-sync", type=int, default=4,
                    help="verify rounds per host sync (1 = host-driven)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--request-retries", type=int, default=0,
                    help="re-admissions granted after a retryable "
                         "per-request failure (a quarantined row, an "
                         "admission fault) before the request fails")
    ap.add_argument("--max-request-seconds", type=float, default=None,
                    metavar="S",
                    help="per-request wall-time bound: a request running "
                         "past it fails with a 'timeout' error")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault-injection plan, e.g. "
                         "'seed=7,alloc=@2;5,poison=3' (default: the "
                         "REPRO_FAULT_PLAN environment variable)")
    ap.add_argument("--use-verify-kernel", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="run the Gumbel-max verify through the spec_verify "
                         "op (the CUDA kernel on the GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = TransformerLM.init(cfg, seed=0, device=device)
    engine = ServingEngine(cfg, params, batch=args.batch,
                           window_max=args.window, max_len=args.max_len,
                           eps_key=1, block_size=args.block_size,
                           adaptive=not args.no_adaptive,
                           prefix_cache=not args.no_prefix_cache,
                           rounds_per_sync=args.rounds_per_sync,
                           use_verify_kernel=args.use_verify_kernel,
                           request_retries=args.request_retries,
                           max_request_seconds=args.max_request_seconds,
                           faults=FaultPlan.parse(args.fault_plan or ""),
                           device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab,
                                       size=int(rng.integers(2, 8))),
            new_tokens=args.new_tokens))
    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    m = engine.export_metrics()
    total_new = sum(r.new_tokens for r in done)
    print(f"served {len(done)} requests / {total_new} tokens "
          f"in {m['rounds']} verify rounds ({dt:.1f}s) on {device}")
    print(f"ARM calls vs ancestral baseline: "
          f"{100.0 * m['arm_calls_vs_ancestral']:.1f}% "
          f"(paged engine, W<= {args.window}, "
          f"adaptive={not args.no_adaptive})")
    print("telemetry: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in m.items()}, indent=2))
    for r in done[:3]:
        print(f"  req {r.uid}: calls={r.calls_used} "
              f"prefill={r.prefill_calls} " + (f"tokens={r.result[:12]}…"
                                               if r.ok else f"{r.error}"))


if __name__ == "__main__":
    main()
