"""Dry run on the meta device: every (architecture x input shape) pair.

The port of the reference's ``launch/dryrun.py``. Where the reference
lowers and compiles each step against abstract parameters on the
production mesh, the port builds the model on PyTorch's meta device
(shapes and dtypes, no storage) and runs the step there under the op
census (``analysis/census.py``) and ``FlopCounterMode``: nothing is
allocated and no kernel runs, yet every op the step would issue is seen.
The train step runs forward and backward with the optimizer's update;
prefill and the decode window follow the reference's ``lower_prefill`` and
``lower_decode``. The kernel wrappers take their plain versions on meta
and count the launches the card would make (``kernels.META_CALLS``): the
decode window's, whose route is an argument. The full-sequence mixers
(flash attention, WKV's zero-state form) choose their kernel by device,
so on meta they take the CPU's plain route and count no call.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # full sweep

Each record (``<out>/<arch>__<shape>.json``, ``build/dryrun/`` by
default) holds ``flops`` (``FlopCounterMode``'s count of the products the
plain versions compute: attention over the full square, MoE experts over
their capacity's slots), ``param_bytes``, ``optimizer_bytes`` (train),
``cache_bytes`` (decode: the window's new cache, the reference's
``_window_cache_shape``), ``peak_bytes`` (the census's peak of live bytes
the step allocated: activations, gradients, new caches), ``aten_ops``,
``kernel_calls`` by name and ``fits_one_card``: whether parameters,
optimizer state, cache and that peak fit the card's 80 GB. These are
reckonings from shapes, not measurements. ``mesh`` is null: the model
axis shards serving parameters since item 20b, but the dry run's
per-mesh reckoning (the training step's FSDP and TP placement) is
ROADMAP item 20c.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.census import Census
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch.serve import make_serve_step
from repro_torch.launch.train import make_optimizer, make_train_step
from repro_torch.models import frontends
from repro_torch.models.transformer import TransformerLM

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
DECODE_WINDOW = 8
CARD_BYTES = 80e9           # one H100's HBM
PREFILL_MOE_CAPACITY = 2.0  # the reference's bounded prefill capacity
META = torch.device("meta")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def abstract_params(cfg):
    """The parameters on the meta device: shapes and dtypes, no storage."""
    return TransformerLM.init(cfg, seed=0, device=META)


def _tokens(B: int, T: int):
    return torch.zeros((B, T), dtype=torch.int64, device=META)


def train_step(cfg, shape, params):
    """``(fn, args, optimizer state)`` of one train step at the shape's
    global batch: ``lm_loss`` forward and backward with each layer
    rematerialized, clipping and the optimizer's update in place."""
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(cfg, opt, remat=True)
    B = shape.global_batch
    args = (params, state, _tokens(B, shape.seq_len),
            frontends.prefix_spec(cfg, B))
    return step, args, state


def prefill_step(cfg, shape, params):
    """``(fn, args)`` of the prompt's forward pass at MoE capacity 2.0
    (no-drop at 32k tokens is a 100x blow-up), last position's logits."""
    def fn(params, tokens, prefix):
        with torch.no_grad():
            logits, _, _ = TransformerLM.apply(
                params, cfg, tokens, prefix,
                moe_capacity=PREFILL_MOE_CAPACITY)
            return logits[:, -1]
    B = shape.global_batch
    return fn, (params, _tokens(B, shape.seq_len),
                frontends.prefix_spec(cfg, B))


def _decode_inputs(cfg, shape):
    B, W = shape.global_batch, DECODE_WINDOW
    # the reference rounds the cache up to a multiple of 256 positions
    S = -(-(shape.seq_len + W) // 256) * 256
    cache = TransformerLM.init_cache(cfg, B, S, cfg.param_dtype, device=META)
    return (_tokens(B, W), cache,
            torch.zeros((B,), dtype=torch.int64, device=META),
            torch.zeros((B, W, cfg.vocab), dtype=torch.float32, device=META))


def decode_step(cfg, shape, params):
    """``(fn, args)`` of one verify window on the kernel route (the serve
    step: decode, Gumbel-max verify, accept, state selection)."""
    step = make_serve_step(cfg, window=DECODE_WINDOW, use_kernel=True)

    def fn(params, cand, cache, cache_len, eps):
        with torch.no_grad():
            return step(params, cand, cache, cache_len, eps)
    return fn, (params,) + _decode_inputs(cfg, shape)


def window_cache_bytes(cfg, shape, params) -> int:
    """Bytes of the decode window's new cache (every recurrent state per
    position), as the reference's ``_window_cache_shape``."""
    cand, cache, cache_len, _ = _decode_inputs(cfg, shape)
    with torch.no_grad():
        _, _, new = TransformerLM.decode_window(params, cfg, cand, cache,
                                                cache_len, use_kernel=True)
    return tree_bytes(new)


def run_pair(arch: str, shape_name: str, out_dir, reduced: bool = False):
    """One pair's record, written to ``out_dir``."""
    shape = SHAPES[shape_name]
    tag = f"{arch}__{shape_name}"
    path = Path(out_dir) / (tag + ".json")
    base = {"arch": arch, "shape": shape_name, "mesh": None,
            "reduced": reduced}
    ok, reason = shape_applicable(arch, shape_name)
    if not ok:
        rec = dict(base, status="skipped", reason=reason)
        path.write_text(json.dumps(rec, indent=1))
        print(f"[skip] {tag}: {reason}")
        return rec
    t0 = time.time()
    try:
        cfg = get_config(arch, reduced=reduced)
        params = abstract_params(cfg)
        opt_bytes = cache_bytes = 0
        if shape.kind == "train":
            fn, args, state = train_step(cfg, shape, params)
            opt_bytes = tree_bytes(state)
        elif shape.kind == "prefill":
            fn, args = prefill_step(cfg, shape, params)
        else:
            fn, args = decode_step(cfg, shape, params)
            cache_bytes = window_cache_bytes(cfg, shape, params)
        census = Census()
        with census, FlopCounterMode(display=False) as flops:
            fn(*args)
        param_bytes = tree_bytes(params)
        need = param_bytes + opt_bytes + cache_bytes + census.peak_bytes
        rec = dict(base, status="ok", flops=int(flops.get_total_flops()),
                   param_bytes=param_bytes, optimizer_bytes=opt_bytes,
                   cache_bytes=cache_bytes, peak_bytes=census.peak_bytes,
                   aten_ops=len(census.ops),
                   kernel_calls={k: v for k, v in census.meta_calls.items()
                                 if v},
                   fits_one_card=need <= CARD_BYTES,
                   decode_window=(DECODE_WINDOW if shape.kind == "decode"
                                  else None),
                   seconds=round(time.time() - t0, 2))
        print(f"[ok] {tag}: flops={rec['flops']:.3e} params="
              f"{param_bytes / 1e9:.3f} GB opt={opt_bytes / 1e9:.3f} GB "
              f"cache={cache_bytes / 1e9:.3f} GB peak="
              f"{census.peak_bytes / 1e9:.3f} GB fits={rec['fits_one_card']}")
    except Exception as e:  # noqa: BLE001 -- a sweep records every failure
        rec = dict(base, status="error", error=str(e)[:2000],
                   trace=traceback.format_exc()[-4000:])
        print(f"[ERR] {tag}: {str(e)[:200]}")
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch, shape) pair")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs instead of the published "
                         "widths")
    ap.add_argument("--skip-existing", action="store_true",
                    help="keep a pair's ok or skipped record")
    ap.add_argument("--out", default=str(ART_DIR))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        jobs = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    n_err = 0
    for arch, shape_name in jobs:
        path = Path(args.out) / f"{arch}__{shape_name}.json"
        if args.skip_existing and path.exists():
            rec = json.loads(path.read_text())
            if rec.get("status") in ("ok", "skipped"):
                print(f"[cached] {arch}__{shape_name}")
                continue
        rec = run_pair(arch, shape_name, args.out, reduced=args.reduced)
        n_err += rec["status"] == "error"
    print(f"dry-run sweep complete; errors: {n_err}")
    return n_err


if __name__ == "__main__":
    raise SystemExit(main())
