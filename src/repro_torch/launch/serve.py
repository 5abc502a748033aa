"""Serving launcher: predictive sampling through the port's paged serving
engine.

``python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced --requests 6``

Initializes random weights from a seed, submits ``--requests`` requests
with random prompts (the reference launcher's generator) and drains them
through ``ServingEngine``. Runs on the GPU unless ``--device cpu``.
``--lookahead`` / ``--max-head-bypass`` / ``--no-preempt`` /
``--preempt-floor`` tune the saturation scheduler (lookahead admission,
priority preemption with exact resume); ``--staging-slots`` /
``--adaptive-rounds`` turn on staged adoption (queued requests adopted by
freed rows inside the round loop, ``rounds_per_sync`` retuned from idle
row-rounds). ``--durable-dir DIR`` makes the engine crash-safe: a
write-ahead request journal, a scheduler checkpoint at every host sync and
a disk tier below the host arena, all under DIR; a run over a DIR a killed
run left recovers every request it had accepted (``restore``) before it
submits its own. ``--journal-fsync-every`` batches the journal's fsync;
``--no-disk-tier`` keeps the journal and checkpoint without the disk tier.
On a model axis (``--mesh D,M``) rank 0 writes the journal and the
checkpoints under DIR and each rank r > 0 keeps its disk tier under
``DIR/rank{r}``; a second run over DIR restores on every rank.
``--no-donate`` copies the paged cache out of place at every dispatch, as
the reference's undonated round writes a fresh pool (an A/B of what the
in-place update saves; the tokens do not change). ``--mesh DATA`` serves
on a data-parallel mesh of DATA shards, one card each, or on the devices
``--mesh-devices`` names (``cpu,cpu``; ``cuda:0,cuda:0`` puts two shards
on one card); ``--no-rebalance`` keeps admission from migrating a
resident between shards. ``--mesh DATA,MODEL`` with MODEL > 1 spawns
MODEL processes, one model rank each (tensor-parallel parameters, expert
parallelism, ``torch.distributed`` over a ``FileStore`` in a temporary
directory), each driving the DATA shards on the devices ``--mesh-devices``
names (DATA devices shared by every rank, or DATA x MODEL, rank by rank;
default one card a shard and rank) over NCCL where every rank has cards
of its own, gloo otherwise. Every rank serves the same requests;
rank 0 prints. On the card the kernels are built once, before the ranks
start.

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
from repro_torch.serving.topology import ServingTopology


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


def mesh_sizes(mesh_arg: str) -> tuple:
    """``--mesh DATA[,MODEL]`` as ``(data, model)``."""
    try:
        parts = [int(p) for p in mesh_arg.split(",")]
    except ValueError:
        parts = []
    if not 1 <= len(parts) <= 2:
        raise SystemExit(f"--mesh wants DATA or DATA,MODEL, got {mesh_arg!r}")
    return tuple((parts + [1])[:2])


def make_serving_topology(mesh_arg: str, devices_arg=None, rank=None,
                          store_path=None):
    """``--mesh DATA[,MODEL]`` (and ``--mesh-devices D0,D1,...``) as a
    ``ServingTopology``. Without a device list each shard (of each model
    rank) takes a card of its own; too few cards is an error. With MODEL >
    1 this process is model rank ``rank``, joining the group at
    ``store_path``."""
    from repro_torch.launch.mesh import make_host_mesh
    data, model = mesh_sizes(mesh_arg)
    devices = devices_arg.split(",") if devices_arg else None
    try:
        return ServingTopology(make_host_mesh(
            data, model, devices=devices, rank=rank, store_path=store_path))
    except (NotImplementedError, RuntimeError, ValueError) as e:
        raise SystemExit(f"--mesh {mesh_arg}: {e}")


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
    ap.add_argument("--mesh", default=None, metavar="DATA[,MODEL]",
                    help="serve on a mesh of DATA data shards (slots, "
                         "block sub-pools and row state split by shard) "
                         "and MODEL model ranks (one process each: "
                         "tensor-parallel parameters, expert parallelism)")
    ap.add_argument("--mesh-devices", default=None, metavar="D0,D1,...",
                    help="with --mesh: each shard's device, DATA of them "
                         "(every model rank's) or DATA x MODEL (rank by "
                         "rank) (default: one card a shard and rank)")
    ap.add_argument("--no-rebalance", action="store_true",
                    help="no shard rebalancing (migrating a resident "
                         "between block sub-pools to admit an arrival)")
    ap.add_argument("--no-donate", action="store_true",
                    help="copy the paged cache (block pools and recurrent "
                         "rows) out of place at every round loop and "
                         "prefill dispatch, as an undonated round writes a "
                         "fresh pool: one read and one write of the cache "
                         "per dispatch (leaf by leaf, so one leaf's copy is "
                         "live beside the cache); the same tokens (for A/B "
                         "measurement)")
    ap.add_argument("--rounds-per-sync", type=int, default=4,
                    help="verify rounds per host sync (1 = host-driven)")
    ap.add_argument("--staging-slots", type=int, default=0,
                    help="queued requests staged for freed rows to adopt "
                         "inside the round loop, with no sync to refill; "
                         "0 = host admission only")
    ap.add_argument("--adaptive-rounds", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="retune rounds_per_sync from the idle row-rounds "
                         "as W is retuned from acceptance (default: on "
                         "exactly when staging is on; needs "
                         "--staging-slots > 0)")
    ap.add_argument("--lookahead", type=int, default=8,
                    help="admission lookahead: queued requests scanned "
                         "past an unroutable head (1 = head-of-line)")
    ap.add_argument("--max-head-bypass", type=int, default=16,
                    help="aging bound: admissions allowed to jump the "
                         "queue head before admission goes head-only")
    ap.add_argument("--no-preempt", action="store_true",
                    help="no priority preemption (parking lower-priority "
                         "slots for a higher-priority head)")
    ap.add_argument("--preempt-floor", type=float, default=0.75,
                    help="progress floor: running slots past this fraction "
                         "of their generation target are never preempted")
    ap.add_argument("--host-cache-mb", type=float, default=None,
                    metavar="MB",
                    help="host cache tier budget in MiB (spilled prefix "
                         "blocks, parked sequences and recurrent-state "
                         "snapshots share one bounded LRU arena, pinned on "
                         "the GPU); default: REPRO_HOST_CACHE_MB or 256")
    ap.add_argument("--no-host-cache", action="store_true",
                    help="no host cache tier (evicted prefix blocks drop, "
                         "parked payloads stay raw host copies, recurrent "
                         "archs never hit a prefix)")
    ap.add_argument("--no-integrity-checks", action="store_true",
                    help="skip the host tier's checksum stamp and verify "
                         "(corruption then goes undetected; to measure "
                         "what the checks cost)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there); "
                         "with --mesh, where the weights are made")
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
    ap.add_argument("--durable-dir", default=None, metavar="DIR",
                    help="crash-safety root: the write-ahead request "
                         "journal, scheduler checkpoints at host syncs and "
                         "the disk tier below the host arena live here; a "
                         "restarted engine over the same DIR recovers every "
                         "accepted request. Default: a volatile engine")
    ap.add_argument("--journal-fsync-every", type=int, default=1,
                    metavar="N",
                    help="fsync the request journal every N records (1: an "
                         "accepted submit is on media before submit() "
                         "returns; more batch the fsync, exposing at most "
                         "N-1 records past the last host sync)")
    ap.add_argument("--no-disk-tier", action="store_true",
                    help="with --durable-dir: keep the journal and the "
                         "checkpoint but no disk tier (arena victims drop; "
                         "a restart prefills every prefix again)")
    ap.add_argument("--use-verify-kernel", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="run the Gumbel-max verify through the spec_verify "
                         "op (the CUDA kernel on the GPU)")
    args = ap.parse_args(argv)
    if args.mesh and mesh_sizes(args.mesh)[1] > 1:
        return _spawn_ranks(args)
    _serve(args)


def _spawn_ranks(args):
    """``--mesh D,M``, M > 1: the kernels built here (on a card) so the
    ranks load one build, then M processes, each ``_serve`` as one model
    rank, with every option (``--durable-dir``, ``--max-request-seconds``)
    passed to each."""
    from repro_torch.sharding import collectives
    if args.device != "cpu" and torch.cuda.is_available():
        from repro_torch import kernels
        kernels.build()
    collectives.spawn(_rank_main, mesh_sizes(args.mesh)[1], args)


def _rank_main(rank, world, store_path, args):
    _serve(args, rank=rank, store_path=store_path)


def _serve(args, rank=None, store_path=None):
    topo = None
    if args.mesh:
        # the shards' devices come from the mesh; ``--device`` is where the
        # weights are made (the engine copies them to each shard's device)
        topo = make_serving_topology(args.mesh, args.mesh_devices, rank,
                                     store_path)
        device = (topo.device(0) if args.device is None
                  else resolve_device(args.device))
    else:
        device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = TransformerLM.init(cfg, seed=0, device=device)
    if topo is not None:
        # this rank's slice of the tensor-parallel leaves (the whole tree
        # without a model axis)
        params = topo.place_params(cfg, params)
    engine = ServingEngine(cfg, params, batch=args.batch,
                           window_max=args.window, max_len=args.max_len,
                           eps_key=1, block_size=args.block_size,
                           adaptive=not args.no_adaptive,
                           prefix_cache=not args.no_prefix_cache,
                           rounds_per_sync=args.rounds_per_sync,
                           staging_slots=args.staging_slots,
                           adaptive_rounds=args.adaptive_rounds,
                           lookahead=args.lookahead,
                           max_head_bypass=args.max_head_bypass,
                           preempt=not args.no_preempt,
                           preempt_floor=args.preempt_floor,
                           topology=topo, rebalance=not args.no_rebalance,
                           use_verify_kernel=args.use_verify_kernel,
                           request_retries=args.request_retries,
                           max_request_seconds=args.max_request_seconds,
                           faults=FaultPlan.parse(args.fault_plan or ""),
                           host_cache_mb=(0 if args.no_host_cache
                                          else args.host_cache_mb),
                           integrity_checks=not args.no_integrity_checks,
                           durable_dir=args.durable_dir,
                           journal_fsync_every=args.journal_fsync_every,
                           disk_tier=not args.no_disk_tier,
                           donate=not args.no_donate,
                           device=None if topo else device)
    first_uid = 0
    if args.durable_dir:
        recovered = engine.restore()
        if recovered and not (topo is not None and topo.model_rank):
            print(f"recovered {recovered} journaled requests from "
                  f"{args.durable_dir}")
        # this run's requests after every uid the journal knows
        first_uid = 1 + max((r.uid for r in engine.queue.requests()
                             + engine.done), default=-1)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(
            uid=first_uid + i,
            prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(2, 8))),
            new_tokens=args.new_tokens))
    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    engine.close()
    m = engine.export_metrics()
    if topo is not None and topo.model_rank:
        return                        # rank 0 prints
    total_new = sum(r.new_tokens for r in done)
    where = (f"{topo.data_size} shards on "
             f"{', '.join(map(str, topo.mesh.devices))}" if topo else device)
    if topo is not None and topo.model_axis is not None:
        where += (f", {topo.model_axis.size} model ranks "
                  f"({topo.mesh.backend})")
    print(f"served {len(done)} requests / {total_new} tokens "
          f"in {m['rounds']} verify rounds ({dt:.1f}s) on {where}")
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
