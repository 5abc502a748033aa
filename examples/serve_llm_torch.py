"""End-to-end serving driver, on the PyTorch port: batched requests
through the predictive-sampling engine with continuous batching.

Trains a reduced qwen3-family LM on repetitive token streams, serves a
queue of ragged requests and reports verify rounds against the
one-call-per-token ancestral baseline. Then it holds every served request
against the per-request solo sampler (``PredictiveSampler.generate``, the
same noise stream): bitwise on the CPU, where both run the plain routes;
on the card, where the engine's paged kernels and the solo sampler's
dense path sum in other orders, under the margin rule (equal up to a
first difference, which must sit where the solo run's top-2 margin is
below 0.25). Any of the ten architectures can be given with ``--arch``.
The port of ``examples/serve_llm.py``.

    PYTHONPATH=src python examples/serve_llm_torch.py --arch qwen3-1.7b
    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import repetitive_tokens
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler, make_eps_fn
from repro_torch.models.losses import lm_loss
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine

EPS_KEY = 1
MAX_LEN = 128
CARD_TOL = 0.25


def margin_fn(cfg, params, dev, tokens, seq_id):
    """The solo path's top-2 margin of ``logits + eps`` at position ``p``
    of ``tokens`` (a dense forward over the first ``p`` tokens)."""
    eps_fn = make_eps_fn(EPS_KEY, cfg.vocab)

    def margin_at(p):
        toks = torch.as_tensor(tokens[:p], device=dev)[None]
        cache = TransformerLM.init_cache(cfg, 1, p, device=dev)
        with torch.no_grad():
            logits, _, _ = TransformerLM.decode_window(
                params, cfg, toks, cache,
                torch.zeros(1, dtype=torch.int64, device=dev))
            e = eps_fn(torch.tensor([seq_id], device=dev),
                       torch.tensor([[p]], device=dev))
        return top2_margin((logits[0, -1].float() + e[0, 0]).cpu())
    return margin_at


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--train-steps", type=int, default=250)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--rounds-per-sync", type=int, default=8,
                    help="max verify rounds per device dispatch")
    ap.add_argument("--staging-slots", type=int, default=4,
                    help="pre-staged requests for in-loop slot adoption; 0 "
                         "disables staging and restores host-only "
                         "admission")
    ap.add_argument("--adaptive-rounds", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="retune rounds_per_sync from observed idle "
                         "row-rounds (default: on exactly when staging is "
                         "on; requires --staging-slots > 0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    print(f"training reduced {cfg.name} on repetitive streams on {dev} ...")
    data = torch.from_numpy(repetitive_tokens(256, 64, cfg.vocab,
                                              seed=0)).long().to(dev)
    params = TransformerLM.init(cfg, seed=0, device=dev)
    opt = optim.adamw(2e-3)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    loss = float("nan")
    for _ in range(args.train_steps):
        batch = data[torch.from_numpy(rng.integers(0, 256, 16)).to(dev)]
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = lm_loss(tree_unflatten(params, leaves), cfg, batch)
        grads = optim.zero_frozen(tree_unflatten(
            params, torch.autograd.grad(loss, leaves)))
        params, state = opt.step(grads, state, params)
    print(f"  final loss {float(loss):.3f}")

    engine = ServingEngine(
        cfg, params, batch=2, window_max=args.window, max_len=MAX_LEN,
        eps_key=EPS_KEY, adaptive=False,
        rounds_per_sync=args.rounds_per_sync,
        staging_slots=args.staging_slots,
        adaptive_rounds=args.adaptive_rounds, device=dev)
    for i in range(args.requests):
        prompt = repetitive_tokens(1, int(rng.integers(4, 10)), cfg.vocab,
                                   seed=100 + i)[0]
        engine.submit(Request(uid=i, prompt=prompt,
                              new_tokens=int(rng.integers(16, 40))))
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    engine.close()
    m = engine.export_metrics()
    total = sum(r.new_tokens for r in done)
    print(f"\nserved {len(done)} requests / {total} new tokens")
    print(f"verify rounds: {m['rounds']} -> "
          f"{100.0 * m['rounds'] / total:.1f}% of the ancestral baseline "
          f"({dt:.1f}s on {dev})")
    for r in done:
        print(f"  req {r.uid}: +{r.new_tokens} tok, {r.calls_used} calls, "
              f"tail={r.result[-8:]}")
    print(f"residency: syncs/token={m['host_syncs_per_token']:.3f} "
          f"rounds/sync={m['rounds_per_sync']:.2f} "
          f"in-loop adoptions={m['in_loop_adoptions']} "
          f"(staged {m['staged_sequences']}, "
          f"k_final={engine.rounds_ctrl.k})")

    # the exactness claim: each request is its own solo run
    assert len(done) == args.requests and all(r.ok for r in done)
    splits = []
    for r in done:
        solo = PredictiveSampler(cfg, params, window=args.window,
                                 max_len=MAX_LEN, eps_key=EPS_KEY,
                                 device=dev)
        with torch.no_grad():
            t, _ = solo.generate(torch.as_tensor(r.prompt)[None],
                                 r.new_tokens,
                                 seq_ids=torch.tensor([r.seq_id]))
        ref = t[0, :len(r.prompt) + r.new_tokens].cpu().numpy()
        if dev.type == "cpu":
            assert np.array_equal(r.result, ref), f"request {r.uid}"
            continue
        split = check_token_agreement(
            ref, r.result, margin_fn(cfg, params, dev, ref, r.seq_id),
            CARD_TOL, start=len(r.prompt))
        if split is not None:
            splits.append((r.uid, split))
    rule = ("bitwise" if dev.type == "cpu" else
            f"under the margin rule at {CARD_TOL} ({len(splits)} split(s) "
            f"at near-ties: {splits})")
    print(f"every request equals its solo run {rule}")


if __name__ == "__main__":
    main()
